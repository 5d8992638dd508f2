"""Timing and roofline accounting on the card."""
