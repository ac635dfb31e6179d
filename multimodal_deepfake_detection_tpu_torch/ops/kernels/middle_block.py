"""K1: the Xception middle-flow residual block as a hand-written Hopper kernel.

Replaces ``multimodal_deepfake_detection_tpu/ops/pallas/sepconv_pos.py::
middle_block_pos_pallas`` (``_pos_kernel``), with weights packed as
``ops/pallas/sepconv_block.py::pack_middle_block``. Source:
``csrc/middle_block.cu`` (CUDA C++, ``sm_90a``), built by ``_build.py`` and
bound through ``ctypes``.

What bounds it on an H100: per rep at 256 frames of 16x16x728, the pointwise
is 2*65,536*728^2 = 69.5 GFLOP (tensor cores), and the depthwise reads and
writes about 95 MB each way (memory). Per rep, one memory-bound depthwise
kernel (whole 16x16 images staged in shared memory with their zero halo,
taps in registers, a 3x3 window sliding along runs of pixels) writes the
bf16 GEMM operand, then one persistent warp-specialised ``wgmma`` GEMM (TMA
into swizzled shared memory, one CTA per SM) whose epilogue fuses bias,
residual and the output cast and stores through shared memory by TMA
(``csrc/middle_block.cu`` has the design). On an H100, TMA loads rows that
start on 64-byte boundaries about 1.4x as fast as C = 728's 1456-byte rows,
so both GEMM operands get rows padded to 32 elements: the packed pointwise
weight is ``(reps, C, ldk)`` and the depthwise result ``(N*H*W, ldk)``.
Fusing the depthwise into the GEMM's A-tile load is later work. The TPU
layout ``(H*W, B, C)`` and its batch padding to 8 existed for the TPU's tiling and are not carried over: this
kernel works on NHWC at any N, H and W.

Rounding points match ``_pos_kernel``: each rep's input is ReLU'd and rounded
to bf16; the 9 taps accumulate in fp32 dy-major; the sum is rounded to bf16
before the pointwise; the pointwise accumulates in fp32 and adds the bias;
only the last rep adds the block input, read in fp32 from the unrounded
input; each rep stores in ``x.dtype``.

The same kernel serves ``ops/pallas/sepconv_block.py``'s image-major entry
points: ``middle_block_pallas`` (v1) and ``middle_block_pallas_v2`` with
``precise=True`` compute this function on ``(B, H, W, C)`` (v1 keeps h in
fp32 between reps but rounds it to bf16 before the taps, which is the same
value at bf16 I/O). ``middle_block_pallas_v2(precise=False)`` sums the taps
in bf16: ``taps="bf16"`` rounds each tap, each product and each running sum
to bf16, dy-major (``__hmul_rn``/``__hadd_rn`` in the kernel, so ``nvcc``
contracts nothing into a bf16 FMA), with its own launch counter,
``middle_block_bf16taps.launches``.
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

TAPS = {"fp32": "dy", "bf16": "bf16"}  # K1's tap switch -> the depthwise order


def middle_block_ref(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, b: torch.Tensor,
                     *, taps: str = "fp32"):
    """Plain PyTorch version of K1 on NHWC ``x``; same rounding points.

    ``dw (reps, 9, C)`` fp32 taps (index ``dy*3+dx``), ``pw (reps, C, ldk)``
    ``[out, in]`` with ``ldk >= C`` (the first C columns used, as bf16
    values), ``b (reps, C)`` fp32. ``taps``: ``"fp32"`` or ``"bf16"`` (see
    the module docstring).
    """
    order = _order(taps)
    h = x
    for r in range(dw.shape[0]):
        a = torch.relu(h).to(torch.bfloat16).float()
        a16 = depthwise3x3_ref(a, dw[r], order).to(torch.bfloat16).float()
        o = pointwise_ref(a16, pw[r], b[r])
        if r + 1 == dw.shape[0]:
            o = o + x.float()
        h = o.to(x.dtype)
    return h


def _order(taps: str) -> str:
    if taps not in TAPS:
        raise ValueError(f"middle_block: taps must be 'fp32' or 'bf16', got {taps!r}")
    return TAPS[taps]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("middle_block")
    lib.mdfd_middle_block.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.mdfd_middle_block.restype = ctypes.c_int
    lib.mdfd_error_string.argtypes = [ctypes.c_int]
    lib.mdfd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dw, pw, b) -> None:
    check_x("middle_block", x)
    C, reps, ldk = x.shape[-1], dw.shape[0], pw.shape[-1]
    check_widths("middle_block", C=C, **{"pw's row length": ldk})
    if ldk < C:
        raise ValueError(f"middle_block: pw's rows ({ldk}) must hold C = {C}")
    check_operands("middle_block", x, (
        ("dw", dw, (reps, 9, C), torch.float32),
        ("pw", pw, (reps, C, ldk), torch.bfloat16),
        ("b", b, (reps, C), torch.float32),
    ))


def launch_middle_block(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, b: torch.Tensor,
                        taps: str) -> torch.Tensor:
    """The CUDA implementation of ``mdfd::middle_block``: launches the kernel
    (or raises) and counts the launch."""
    _check(x, dw, pw, b)
    lib = _lib()
    N, H, W, C = x.shape
    ldk = pw.shape[-1]
    out = torch.empty_like(x)
    scratch = torch.empty((N * H * W, ldk), dtype=torch.bfloat16, device=x.device)
    launch(lib, "mdfd_middle_block", x,
           x.data_ptr(), dw.data_ptr(), pw.data_ptr(), b.data_ptr(), out.data_ptr(),
           scratch.data_ptr(), N, H, W, C, ldk, dw.shape[0], int(x.dtype == torch.float32),
           int(taps == "bf16"))
    (middle_block_bf16taps if taps == "bf16" else middle_block).launches += 1
    return out


def middle_block(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, b: torch.Tensor,
                 *, taps: str = "fp32"):
    """One middle-flow block on NHWC ``x`` -> same shape and dtype, through
    the custom op ``torch.ops.mdfd.middle_block`` (``library.py``).

    A CPU tensor takes :func:`middle_block_ref`. A CUDA tensor launches the
    kernel or raises: there is no fallback. ``middle_block.launches`` counts
    launches with fp32 taps, ``middle_block_bf16taps.launches`` those with
    ``taps="bf16"``.
    """
    _order(taps)
    if op_device(x):
        return torch.ops.mdfd.middle_block(x, dw, pw, b, taps)
    return launch_middle_block(x, dw, pw, b, taps)


def middle_block_bf16taps(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, b: torch.Tensor):
    """:func:`middle_block` with ``taps="bf16"``, the kernel of
    ``middle_block_pallas_v2(precise=False)``; ``.launches`` counts its
    launches."""
    return middle_block(x, dw, pw, b, taps="bf16")


middle_block.launches = 0
middle_block_bf16taps.launches = 0


def pack_middle_block(units) -> tuple:
    """Folded middle-block units -> the kernel's operands.

    ``units``: per rep ``(dw (C, 1, 3, 3), pw (C, C, 1, 1) [out, in], b (C,))``.
    Returns ``dw (reps, 9, C)`` fp32, ``pw (reps, C, ldk)`` bf16 ``[out, in]``
    (the 1x1 conv weight's own layout; the JAX packer's ``[in, out]``
    transposed, so the GEMM reads both operands K-major) with rows
    zero-padded to ``ldk = 32 * ceil(C / 32)`` (``_plain.PW_ROW_ALIGN``), and
    ``b (reps, C)`` fp32, all contiguous.
    """
    dws, pws, bs = zip(*((dw_taps(dw), pad_rows(pw[:, :, 0, 0]), b.float()) for dw, pw, b in units))
    return torch.stack(dws), torch.stack(pws), torch.stack(bs)
