"""Static-shape length buckets (counterpart of the JAX package's data/collate.py).

Clips are padded up to a bucket boundary so the engine sees a small fixed set
of shapes; a ``lengths`` vector rides along so padding can be masked.
"""
from __future__ import annotations

from typing import Optional, Sequence


def bucket_length(t: int, buckets: Optional[Sequence[int]]) -> int:
    """Smallest bucket >= t; ``t`` if there are no buckets; the largest bucket
    if ``t`` exceeds them all (the caller truncates)."""
    if not buckets:
        return t
    for b in buckets:
        if t <= b:
            return b
    return buckets[-1]
