"""K5: one Xception separable unit as a hand-written Hopper kernel.

Replaces ``multimodal_deepfake_detection_tpu/ops/pallas/sepconv_unit.py::
sepconv_unit_pallas`` (``_unit_kernel``), ``[ReLU] -> dw3x3 -> pw + b ->
[ReLU]`` at any channel counts, with weights packed as that module's
``pack_unit``. Source: ``csrc/sepconv_unit.cu`` (CUDA C++, ``sm_90a``),
built by ``_build.py`` and bound through ``ctypes``.

What bounds it on an H100: its targets are the exit sepconvs conv3 (1024 ->
1536) and conv4 (1536 -> 2048) at 8^2, 51.5 and 103 GFLOP of bf16 pointwise
work at 256 frames against well under 0.04 ms of activation traffic: bound
by operations. The design is K1's two launches: its tiled depthwise writing
the bf16 GEMM operand, and its persistent TMA/``wgmma`` GEMM
(``csrc/bf16_gemm.cuh``) with a bias (+ ReLU) epilogue that stores in x's
dtype through shared memory by TMA; keeping the depthwise result on chip is
later work.
The TPU's row stripes (``row_tile``) are VMEM scheduling and not carried over.

Rounding points match ``_unit_kernel``: the input is ReLU'd (with
``leading_relu``) and rounded to bf16; the 9 taps accumulate in fp32
dy-major; the sum is rounded to bf16; the pointwise accumulates in fp32 and
adds the bias; the trailing ReLU (with ``trailing_relu``) comes last; the
output is stored in x's dtype (at fp32 I/O not rounded to bf16). The JAX
kernel multiplies by ``pw`` in whatever dtype it is given; the port's weights
are bf16, as every serving path's are.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import launch, load_library, op_device
from ._plain import (
    check_operands,
    check_widths,
    check_x,
    depthwise3x3_ref,
    dw_taps,
    pad_rows,
    pointwise_ref,
)


def sepconv_unit_ref(x, dw, pw, b, *, leading_relu: bool, trailing_relu: bool):
    """Plain PyTorch version of K5 on NHWC ``x (N, H, W, Cin)``; same rounding
    points. ``dw (9, Cin)`` fp32 taps; ``pw (Cout, ldk)`` ``[out, in]`` with
    ``ldk >= Cin`` (the first Cin columns used, as bf16 values); ``b (Cout,)``
    fp32. Returns ``(N, H, W, Cout)`` in x's dtype."""
    a = torch.relu(x.float()) if leading_relu else x.float()
    a = depthwise3x3_ref(a.to(torch.bfloat16).float(), dw).to(torch.bfloat16).float()
    o = pointwise_ref(a, pw, b)
    return (torch.relu(o) if trailing_relu else o).to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("sepconv_unit")
    lib.mdfd_sepconv_unit.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.mdfd_sepconv_unit.restype = ctypes.c_int
    lib.mdfd_error_string.argtypes = [ctypes.c_int]
    lib.mdfd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dw, pw, b) -> None:
    check_x("sepconv_unit", x)
    if pw.dim() != 2:
        raise ValueError("sepconv_unit: pw must be a 2-D [out, in] matrix")
    Cin = x.shape[-1]
    Cout, ldk = pw.shape
    check_widths("sepconv_unit", Cin=Cin, Cout=Cout, **{"pw's row length": ldk})
    if ldk < Cin:
        raise ValueError(f"sepconv_unit: pw's rows ({ldk}) must hold Cin = {Cin}")
    check_operands("sepconv_unit", x, (
        ("dw", dw, (9, Cin), torch.float32),
        ("pw", pw, (Cout, ldk), torch.bfloat16),
        ("b", b, (Cout,), torch.float32),
    ))


def launch_sepconv_unit(x, dw, pw, b, leading_relu: bool, trailing_relu: bool) -> torch.Tensor:
    """The CUDA implementation of ``mdfd::sepconv_unit``: launches the kernel
    (or raises) and counts the launch."""
    _check(x, dw, pw, b)
    lib = _lib()
    N, H, W, Cin = x.shape
    Cout, ldk = pw.shape
    out = torch.empty((N, H, W, Cout), dtype=x.dtype, device=x.device)
    scratch = torch.empty((N * H * W, ldk), dtype=torch.bfloat16, device=x.device)
    launch(lib, "mdfd_sepconv_unit", x,
           x.data_ptr(), dw.data_ptr(), pw.data_ptr(), b.data_ptr(), out.data_ptr(),
           scratch.data_ptr(), N, H, W, Cin, Cout, ldk, int(leading_relu), int(trailing_relu),
           int(x.dtype == torch.float32))
    sepconv_unit.launches += 1
    return out


def sepconv_unit(x, dw, pw, b, *, leading_relu: bool, trailing_relu: bool):
    """One separable unit on NHWC ``x (N, H, W, Cin)`` -> ``(N, H, W, Cout)``
    in x's dtype, through the custom op ``torch.ops.mdfd.sepconv_unit``;
    operands as :func:`pack_unit` returns them.

    A CPU tensor takes :func:`sepconv_unit_ref`. A CUDA tensor launches the
    kernel or raises: there is no fallback. ``sepconv_unit.launches`` counts
    kernel launches (one per call: the unit's two CUDA launches).
    """
    if op_device(x):
        return torch.ops.mdfd.sepconv_unit(x, dw, pw, b, leading_relu, trailing_relu)
    return launch_sepconv_unit(x, dw, pw, b, leading_relu, trailing_relu)


sepconv_unit.launches = 0


def pack_unit(dw, pw, b) -> tuple:
    """Folded separable unit ``(dw (Cin, 1, 3, 3), pw (Cout, Cin, 1, 1) [out,
    in], b (Cout,))`` -> ``dw (9, Cin)`` fp32, ``pw (Cout, ldk)`` bf16 with
    rows zero-padded to ``PW_ROW_ALIGN`` elements (the JAX packer's ``[in,
    out]`` transposed, so the GEMM reads both operands K-major), ``b`` fp32,
    all contiguous."""
    return dw_taps(dw), pad_rows(pw[:, :, 0, 0]), b.float().contiguous()
