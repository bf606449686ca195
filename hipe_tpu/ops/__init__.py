"""Compute ops: integer-exact image filters (XLA + one Pallas GPU kernel)."""
