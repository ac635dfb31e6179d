"""Xception, BN folding, temporal heads and the serving engine."""
