"""Entry points of the ported slices."""
