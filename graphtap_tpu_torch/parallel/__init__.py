"""Vertex/tile partition (one device in this version)."""
