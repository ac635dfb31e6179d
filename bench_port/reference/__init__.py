"""The plain reference: the configurations' models in fp32 PyTorch and NumPy.

Nothing here imports the port, JAX or the JAX package, and nothing takes
what the port made: the weights come from the bundle's bytes through this
package's own loader, the BN statistics are applied unfolded, and the MFCC
is this package's own copy of the arithmetic. Run it with TF32 off
(:func:`ieee_fp32`).
"""
from __future__ import annotations

import contextlib
import io

import numpy as np
import torch


def load(bundle) -> dict:
    """``{key: fp32 tensor}`` of an ``.npz`` bundle (a path or bytes)."""
    if isinstance(bundle, (bytes, bytearray)):
        bundle = io.BytesIO(bundle)
    elif hasattr(bundle, "seek"):
        bundle.seek(0)
    with np.load(bundle) as z:
        return {k: torch.from_numpy(np.array(z[k], np.float32)) for k in z.files}


def to(weights: dict, device) -> dict:
    return {k: v.to(device) for k, v in weights.items()}


@contextlib.contextmanager
def ieee_fp32():
    """TF32 off in cuDNN and cuBLAS for the block, restored after."""
    b = torch.backends
    before = b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = before
