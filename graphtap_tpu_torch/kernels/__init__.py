"""Semirings, portable SpMV and the v3 panel-route pipeline (K1-K4)."""
