"""Tile construction (numpy, host-side)."""
