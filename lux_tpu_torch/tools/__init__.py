"""Measurement tools for the port's kernels; each runs on the card."""
