"""The int8 depthwise 3x3 with its dequant epilogue, as a hand-written Hopper kernel.

No TPU kernel is replaced: the JAX package computes
``multimodal_deepfake_detection_tpu/ops/quant.py::depthwise_conv2d_w8a8`` as
an XLA op. PyTorch has no int8 depthwise convolution on CUDA, so the port
writes one. Source: ``csrc/dw_w8a8.cu`` (CUDA C++, ``sm_90a``), built by
``_build.py`` and bound through ``ctypes``.

What bounds it on an H100: memory. At the largest site of 256 frames at
256^2, block 1 at (256, 125, 125, 128) bf16, it reads and writes 1.02 GB
each way: 0.61 ms at 3.35 TB/s. The kernel reads each input element into a
shared-memory tile of up to 8 rows by 64 columns with its halo (quantized to
int8 as it lands), sums the 9 taps exactly in int32 and writes
``float(acc) * sc`` in the output dtype. It takes any width.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..quant import quantize
from ._build import launch, load_library, op_device


def dw_w8a8_ref(
    x: torch.Tensor,
    w_q: torch.Tensor,
    s_in: torch.Tensor,
    sc: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel on NHWC ``x``.

    ``w_q (C, 1, 3, 3)`` int8, ``s_in`` scalar or ``(C,)``, ``sc = s_dq * s_w``
    ``(C,)``. The 9-tap int32 shift-add, exact at every size.
    """
    N, H, W, C = x.shape
    xi = F.pad(quantize(x, s_in).to(torch.int32), (0, 0, 1, 1, 1, 1))
    w = w_q.reshape(C, 9).to(torch.int32)
    y = sum(
        xi[:, dy : dy + H, dx : dx + W, :] * w[:, dy * 3 + dx]
        for dy in range(3)
        for dx in range(3)
    )
    return (y.float() * sc).to(out_dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("dw_w8a8")
    lib.mdfd_dw_w8a8.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.mdfd_dw_w8a8.restype = ctypes.c_int
    lib.mdfd_error_string.argtypes = [ctypes.c_int]
    lib.mdfd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, w_q, s_in, sc, out_dtype) -> None:
    if not x.is_cuda:
        raise ValueError(f"dw_w8a8: x must be a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dw_w8a8: x must be (N, H, W, C) bf16/fp32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dw_w8a8: out_dtype must be bf16/fp32, got {out_dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("dw_w8a8: x must be NHWC-contiguous and 16-byte aligned")
    N, H, W, C = x.shape
    if C % 8:
        raise ValueError(f"dw_w8a8: C={C} must be a multiple of 8 (16-byte rows)")
    if N * H * W >= 2**31:
        raise ValueError("dw_w8a8: N*H*W must fit in int32")
    for name, t, shape, dtype in (
        ("w_q", w_q, (C, 1, 3, 3), torch.int8),
        ("s_in", s_in, (C,), torch.float32),
        ("sc", sc, (C,), torch.float32),
    ):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"dw_w8a8: {name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"dw_w8a8: {name} must be contiguous, 16-byte aligned "
                             f"and on {x.device}")


def launch_dw_w8a8(x: torch.Tensor, w_q: torch.Tensor, s_in: torch.Tensor, sc: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """The CUDA implementation of ``mdfd::dw_w8a8``: launches the kernel (or
    raises) and counts the launch."""
    C = x.shape[-1]
    s_in = s_in.float().expand(C).contiguous() if s_in.numel() == 1 else s_in
    _check(x, w_q, s_in, sc, out_dtype)
    lib = _lib()
    N, H, W, _ = x.shape
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    launch(lib, "mdfd_dw_w8a8", x,
           x.data_ptr(), s_in.data_ptr(), w_q.data_ptr(), sc.data_ptr(), out.data_ptr(),
           N, H, W, C, int(x.dtype == torch.float32), int(out_dtype == torch.float32))
    dw_w8a8.launches += 1
    return out


def dw_w8a8(x: torch.Tensor, w_q: torch.Tensor, s_in: torch.Tensor, sc: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    """int8 depthwise 3x3 (stride 1, zero pad 1) on NHWC ``x`` -> ``out_dtype``,
    through the custom op ``torch.ops.mdfd.dw_w8a8``.

    ``w_q (C, 1, 3, 3)`` int8, ``s_in`` fp32 scalar or ``(C,)``, ``sc (C,)``
    fp32 (``s_dq * s_w``). A CPU tensor takes :func:`dw_w8a8_ref`; a CUDA
    tensor launches the kernel or raises. ``dw_w8a8.launches`` counts kernel
    launches.
    """
    if op_device(x):
        return torch.ops.mdfd.dw_w8a8(x, w_q, s_in, sc, out_dtype)
    return launch_dw_w8a8(x, w_q, s_in, sc, out_dtype)


dw_w8a8.launches = 0
