"""Deterministic, checkpointable data pipelines."""
