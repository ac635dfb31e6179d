"""Batching helpers (numpy only)."""
