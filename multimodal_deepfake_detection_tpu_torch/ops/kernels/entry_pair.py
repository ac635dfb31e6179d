"""K4: the Xception separable pair as a hand-written Hopper kernel.

Replaces three TPU kernels of ``multimodal_deepfake_detection_tpu/ops/
pallas/``, three memory schemes for one function,
``[ReLU] -> dw3x3 -> pw(Cin->Cmid) + b0 -> ReLU -> dw3x3 -> pw(Cmid->Cout) + b1``:

- ``sepconv_entry.py::entry_pair_pallas`` (``_entry_kernel``, and its
  ``entry_pair``): column-sum taps, bf16 mid — ``col_sums=True``;
- ``sepconv_stream.py::sepconv_pair_stream_pallas`` (``_stream_kernel``):
  dy-major taps, and unit 0's ``pw0 + b0`` kept in fp32 and read unrounded
  by unit 1 — ``col_sums=False, mid_fp32=True``;
- ``sepconv_stream2.py::sepconv_pair_stream2_pallas`` (``_stream2_kernel``):
  bf16 mid, dy-major taps without ``dx_roll`` and column sums with it —
  ``col_sums=dx_roll``.

Weights are packed as the JAX ``pack_pair`` / ``pack_pair2`` do, one
``pack_unit`` per unit. Source: ``csrc/entry_pair.cu`` (CUDA C++, ``sm_90a``),
built by ``_build.py`` and bound through ``ctypes``.

What bounds it on an H100: at 256 frames of 256^2 the pairs of the stride-2
blocks 1 and 2 are bound by one read of x and one write of the output (0.46
and 0.23 ms at 3.35 TB/s), those of blocks 3 and 12 by their bf16 pointwise
work (376 and 166 GFLOP). The design (``csrc/sepconv_pair.cuh``, shared
with ``entry_block.cu``) is two launches, one per unit, each a GEMM whose
producer warps compute the unit's depthwise straight into the A tile
(``csrc/dw_gemm.cuh``): the depthwise results never reach device memory;
``mid`` does. The TPU-only storage is not carried over: the port takes and
returns dense NHWC at any N, H and W, with no bordered ``W2`` columns, no
channels padded to 128 lanes and no stripe heights that must divide H.

Rounding points: x is rounded to bf16 (and ReLU'd with ``leading_relu0``);
each depthwise takes fp32 products in the chosen order and is rounded to
bf16; each pointwise accumulates in fp32 and adds its bias; ``mid =
ReLU(pw0 + b0)``, rounded to bf16 unless ``mid_fp32``; the output is ``pw1 +
b1`` in x's dtype (at fp32 I/O not rounded to bf16). The stream kernels
multiply by ``pw`` in whatever dtype they are given; the port's weights are
bf16, as every serving path's are.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ._build import launch, load_library, op_device
from ._plain import check_operands, check_widths, check_x, depthwise3x3_ref, pointwise_ref
from .sepconv_unit import pack_unit


def entry_pair_ref(x, dw0, pw0, b0, dw1, pw1, b1, *, leading_relu0: bool, col_sums: bool = True,
                   mid_fp32: bool = False):
    """Plain PyTorch version of K4 on NHWC ``x (N, H, W, Cin)``; same rounding
    points. ``dw0 (9, Cin)``, ``dw1 (9, Cmid)`` fp32 taps; ``pw0 (Cmid,
    ldk0)``, ``pw1 (Cout, ldk1)`` ``[out, in]`` with rows at least as long
    as their input width (the first Cin or Cmid columns used, as bf16
    values); ``b0 (Cmid,)``, ``b1 (Cout,)`` fp32. Returns ``(N, H, W, Cout)``
    in x's dtype."""
    order = "cols" if col_sums else "dy"
    xb = x.to(torch.bfloat16).float()
    a = torch.relu(xb) if leading_relu0 else xb
    a = depthwise3x3_ref(a, dw0, order).to(torch.bfloat16).float()
    mid = torch.relu(pointwise_ref(a, pw0, b0))
    if not mid_fp32:
        mid = mid.to(torch.bfloat16).float()
    a = depthwise3x3_ref(mid, dw1, order).to(torch.bfloat16).float()
    return pointwise_ref(a, pw1, b1).to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("entry_pair")
    lib.mdfd_entry_pair.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.mdfd_entry_pair.restype = ctypes.c_int
    lib.mdfd_error_string.argtypes = [ctypes.c_int]
    lib.mdfd_error_string.restype = ctypes.c_char_p
    return lib


def check_pair(kernel: str, x, dw0, pw0, b0, dw1, pw1, b1) -> None:
    """The pair's operands, as :func:`pack_pair` returns them, for a CUDA
    ``x``; shared with K3."""
    check_x(kernel, x)
    if pw0.dim() != 2 or pw1.dim() != 2:
        raise ValueError(f"{kernel}: pw0 and pw1 must be 2-D [out, in] matrices")
    Cin = x.shape[-1]
    (Cmid, ldk0), (Cout, ldk1) = pw0.shape, pw1.shape
    check_widths(kernel, Cin=Cin, Cmid=Cmid, Cout=Cout,
                 **{"pw0's row length": ldk0, "pw1's row length": ldk1})
    if ldk0 < Cin or ldk1 < Cmid:
        raise ValueError(f"{kernel}: pw0's rows ({ldk0}) must hold Cin = {Cin} and pw1's "
                         f"({ldk1}) Cmid = {Cmid}")
    check_operands(kernel, x, (
        ("dw0", dw0, (9, Cin), torch.float32),
        ("pw0", pw0, (Cmid, ldk0), torch.bfloat16),
        ("b0", b0, (Cmid,), torch.float32),
        ("dw1", dw1, (9, Cmid), torch.float32),
        ("pw1", pw1, (Cout, ldk1), torch.bfloat16),
        ("b1", b1, (Cout,), torch.float32),
    ))


def launch_entry_pair(x, dw0, pw0, b0, dw1, pw1, b1, leading_relu0: bool, col_sums: bool,
                      mid_fp32: bool) -> torch.Tensor:
    """The CUDA implementation of ``mdfd::entry_pair``: launches the kernel
    (or raises) and counts the launch."""
    check_pair("entry_pair", x, dw0, pw0, b0, dw1, pw1, b1)
    lib = _lib()
    N, H, W, Cin = x.shape
    (Cmid, ldk0), (Cout, ldk1) = pw0.shape, pw1.shape
    out = torch.empty((N, H, W, Cout), dtype=x.dtype, device=x.device)
    mid = torch.empty((N * H * W, Cmid), dtype=torch.float32 if mid_fp32 else torch.bfloat16,
                      device=x.device)
    launch(lib, "mdfd_entry_pair", x,
           *(t.data_ptr() for t in (x, dw0, pw0, b0, dw1, pw1, b1, out, mid)),
           N, H, W, Cin, Cmid, Cout, ldk0, ldk1, int(leading_relu0), int(col_sums), int(mid_fp32),
           int(x.dtype == torch.float32))
    entry_pair.launches += 1
    return out


def entry_pair(x, dw0, pw0, b0, dw1, pw1, b1, *, leading_relu0: bool, col_sums: bool = True,
               mid_fp32: bool = False):
    """The separable pair on NHWC ``x (N, H, W, Cin)`` -> ``(N, H, W, Cout)``
    in x's dtype, through the custom op ``torch.ops.mdfd.entry_pair``;
    operands as :func:`pack_pair` returns them. The defaults are
    ``entry_pair_pallas``'s switches.

    A CPU tensor takes :func:`entry_pair_ref`. A CUDA tensor launches the
    kernel or raises: there is no fallback. ``entry_pair.launches`` counts
    kernel launches (one per call: the pair's two CUDA launches, one per
    unit).
    """
    args = (x, dw0, pw0, b0, dw1, pw1, b1, leading_relu0, col_sums, mid_fp32)
    if op_device(x):
        return torch.ops.mdfd.entry_pair(*args)
    return launch_entry_pair(*args)


entry_pair.launches = 0


def pack_pair(units) -> tuple:
    """Folded two-unit pair -> the kernel's operands.

    ``units``: two ``(dw (C, 1, 3, 3), pw (Cout, Cin, 1, 1) [out, in], b)``.
    Returns ``dw0 (9, Cin)`` fp32, ``pw0 (Cmid, ldk0)`` bf16, ``b0`` fp32,
    ``dw1 (9, Cmid)``, ``pw1 (Cout, ldk1)``, ``b1``: :func:`pack_unit` of
    each unit.
    """
    (u0, u1) = units
    return pack_unit(*u0) + pack_unit(*u1)
