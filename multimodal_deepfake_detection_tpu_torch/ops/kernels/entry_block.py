"""K3: the Xception stride-2 block (entry blocks 1-3 and block 12) as a
hand-written Hopper kernel.

Replaces ``multimodal_deepfake_detection_tpu/ops/pallas/sepconv_entry.py::
entry_block_pallas`` (``_entry_block_kernel``) and ``sepconv_entry_striped.py::
entry_block_striped_pallas`` (``_striped_kernel``), the same function for
images up to and above 96 rows, with weights packed as
``sepconv_entry.py::pack_entry_block``. Source: ``csrc/entry_block.cu`` (CUDA
C++, ``sm_90a``), built by ``_build.py`` and bound through ``ctypes``. Its
pair stage is K4's (``csrc/sepconv_pair.cuh``, ``entry_pair.py``).

What bounds it on an H100: at 256 frames of 256^2 each block is 192-400
GFLOP of bf16 pointwise work (tensor cores) against one read of x and one
pooled write (memory), so blocks 2, 3 and 12 are bound by operations and
block 1 about evenly by both. The TPU kernel keeps every intermediate in
VMEM, already rounded to bf16; the port keeps the two depthwise results on
chip and ``mid`` and ``outs`` in device memory, at the same rounding points.
Four launches: a gather of x's even rows and columns; unit 0 and unit 1,
each a GEMM whose producer warps compute the unit's depthwise (K3's tap
order) into the A tile (``csrc/dw_gemm.cuh``, K4's pair), with bias + ReLU
into ``mid`` and bias into ``outs``; and the skip GEMM whose epilogue adds
the skip bias and the 3x3/s2 max of ``outs``. The TPU-only pieces are not
carried over: the bordered ``W2`` storage, ``valid_w`` chaining, channels
padded to 128 lanes and stripe heights that divide H. The kernel takes and
returns dense NHWC at any N, H and W.

Rounding points match the TPU kernels: x is rounded to bf16 (also for fp32
input); unit 0's depthwise reads ReLU(x) only with ``leading_relu0``; each
depthwise takes fp32 products, sums each column over dy, then adds the
column sums as ``(dx0 + dx1) + dx2`` and rounds to bf16; each pointwise
accumulates in fp32 and adds its bias; ``mid = bf16(ReLU(pw0 + b0))``,
``outs = bf16(pw1 + b1)``; the 3x3/s2 max pool's padding never wins; the
skip is the bf16 x at even rows and columns times the bf16 ``skw``, in fp32;
the output is ``pooled + (skip + skb)`` (the whole-image kernel's order; the
striped kernel adds ``(pooled + skip) + skb``), cast to x's dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import launch, load_library, op_device
from ._plain import check_operands, pad_rows, pointwise_ref
from .entry_pair import check_pair, entry_pair_ref, pack_pair


def entry_block_ref(x, dw0, pw0, b0, dw1, pw1, b1, skw, skb, *, leading_relu0: bool):
    """Plain PyTorch version of K3 on NHWC ``x``; same rounding points.

    ``dw0 (9, Cin)``, ``dw1 (9, Cmid)`` fp32 taps; ``pw0 (Cmid, ldk0)``,
    ``pw1 (Cout, ldk1)``, ``skw (Cout, ldk0)`` ``[out, in]`` with rows at
    least as long as their input width (the first Cin or Cmid columns used,
    as bf16 values); ``b0 (Cmid,)``, ``b1``, ``skb (Cout,)`` fp32.
    Returns ``(N, (H+1)//2, (W+1)//2, Cout)`` in x's dtype.
    """
    xb = x.to(torch.bfloat16)
    # K4's pair on the bf16 x: column sums, bf16 mid, outs in bf16
    outs = entry_pair_ref(xb, dw0, pw0, b0, dw1, pw1, b1, leading_relu0=leading_relu0).float()
    pooled = F.max_pool2d(outs.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    skip = pointwise_ref(xb.float()[:, ::2, ::2, :], skw, skb)
    return (pooled + skip).to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("entry_block")
    lib.mdfd_entry_block.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 10
                                     + [ctypes.c_void_p])
    lib.mdfd_entry_block.restype = ctypes.c_int
    lib.mdfd_error_string.argtypes = [ctypes.c_int]
    lib.mdfd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dw0, pw0, b0, dw1, pw1, b1, skw, skb) -> None:
    check_pair("entry_block", x, dw0, pw0, b0, dw1, pw1, b1)
    Cout, ldk0 = pw1.shape[0], pw0.shape[1]
    check_operands("entry_block", x, (
        ("skw", skw, (Cout, ldk0), torch.bfloat16),
        ("skb", skb, (Cout,), torch.float32),
    ))


def launch_entry_block(x, dw0, pw0, b0, dw1, pw1, b1, skw, skb, leading_relu0: bool):
    """The CUDA implementation of ``mdfd::entry_block``: launches the kernel
    (or raises) and counts the launch."""
    _check(x, dw0, pw0, b0, dw1, pw1, b1, skw, skb)
    lib = _lib()
    N, H, W, Cin = x.shape
    (Cmid, ldk0), (Cout, ldk1) = pw0.shape, pw1.shape
    Hp, Wp = (H + 1) // 2, (W + 1) // 2
    out = torch.empty((N, Hp, Wp, Cout), dtype=x.dtype, device=x.device)
    scratch = lambda rows, cols: torch.empty((rows, cols), dtype=torch.bfloat16, device=x.device)
    M = N * H * W
    mid, outs, xs = scratch(M, Cmid), scratch(M, Cout), scratch(N * Hp * Wp, ldk0)
    launch(lib, "mdfd_entry_block", x,
           *(t.data_ptr() for t in (x, dw0, pw0, b0, dw1, pw1, b1, skw, skb, out, mid, outs, xs)),
           N, H, W, Cin, Cmid, Cout, ldk0, ldk1, int(leading_relu0), int(x.dtype == torch.float32))
    entry_block.launches += 1
    return out


def entry_block(x, dw0, pw0, b0, dw1, pw1, b1, skw, skb, *, leading_relu0: bool):
    """One stride-2 block on NHWC ``x (N, H, W, Cin)`` -> ``(N, (H+1)//2,
    (W+1)//2, Cout)`` in x's dtype, through the custom op
    ``torch.ops.mdfd.entry_block``; operands as :func:`pack_entry_block`
    returns them.

    A CPU tensor takes :func:`entry_block_ref`. A CUDA tensor launches the
    kernel or raises: there is no fallback. ``entry_block.launches`` counts
    kernel launches (one per call: the block's four CUDA launches).
    """
    args = (x, dw0, pw0, b0, dw1, pw1, b1, skw, skb, leading_relu0)
    if op_device(x):
        return torch.ops.mdfd.entry_block(*args)
    return launch_entry_block(*args)


entry_block.launches = 0


def pack_entry_block(units, skip) -> tuple:
    """Folded stride-2 two-unit block -> the kernel's operands.

    ``units``: two ``(dw (C, 1, 3, 3), pw (Cout, Cin, 1, 1) [out, in], b)``;
    ``skip``: ``(w (Cout, Cin, 1, 1), b)``. Returns ``dw0 (9, Cin)`` fp32,
    ``pw0 (Cmid, ldk0)`` bf16, ``b0`` fp32, ``dw1 (9, Cmid)``, ``pw1 (Cout,
    ldk1)``, ``b1``, ``skw (Cout, ldk0)`` bf16, ``skb`` fp32, all contiguous,
    with bf16 rows zero-padded to ``PW_ROW_ALIGN`` elements (the JAX packer's
    ``[in, out]`` matrices transposed, so the GEMMs read both operands
    K-major).
    """
    skw, skb = skip
    return pack_pair(units) + (pad_rows(skw[:, :, 0, 0]), skb.float().contiguous())
