"""Example workloads ported so far: ``linear_reg``."""
