"""Datasets, batching and synthetic trees (numpy only)."""
