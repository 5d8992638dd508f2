"""Strategies of the port: the lane-ELL hybrid, baselines, registry."""
