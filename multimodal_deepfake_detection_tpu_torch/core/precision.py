"""dtype helpers (counterpart of ``multimodal_deepfake_detection_tpu/core/precision.py``).

Serving computes in bf16 with fp32 parameters, fp32 BN folding and fp32
ArcFace math; the bf16 exponent range equals fp32's, so no loss scaling.
"""
from __future__ import annotations

import contextlib

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """Upcast to at least fp32 (bf16/f16 -> f32; f32 stays; f64 stays f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def parse_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` -> ``torch.dtype``."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; expected one of {sorted(_DTYPES)}") from None


@contextlib.contextmanager
def ieee_fp32():
    """cuDNN's and cuBLAS's TF32 switched off for the ``with`` block, so fp32
    convolutions and matmuls on the card are IEEE fp32 (torch's default lets
    cuDNN round fp32 inputs to TF32's 10-bit mantissa); the process's
    settings come back when the block ends or raises."""
    b = torch.backends
    before = b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = before
