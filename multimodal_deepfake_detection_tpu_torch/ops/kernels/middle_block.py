"""K1: the Xception middle-flow residual block as a hand-written Hopper kernel.

Replaces ``multimodal_deepfake_detection_tpu/ops/pallas/sepconv_pos.py::
middle_block_pos_pallas`` (``_pos_kernel``), with weights packed as
``ops/pallas/sepconv_block.py::pack_middle_block``. Source:
``csrc/middle_block.cu`` (CUDA C++, ``sm_90a``), built by ``_build.py`` and
bound through ``ctypes``.

What bounds it on an H100: per rep at 256 frames of 16x16x728, the pointwise
is 2*65,536*728^2 = 69.5 GFLOP (tensor cores), and the depthwise reads and
writes about 95 MB each way (memory). The design is the simple form: per rep
one memory-bound depthwise kernel (bands of rows staged in shared memory with
their zero halo) that writes the bf16 GEMM operand, then one warp-specialised
``wgmma`` GEMM (TMA into swizzled shared memory) whose epilogue fuses bias,
residual and the output cast. On an H100, TMA loads rows that start on
64-byte boundaries about 1.4x as fast as C = 728's 1456-byte rows, so both
GEMM operands get rows padded to 32 elements: the packed pointwise weight is
``(reps, C, ldk)`` and the depthwise result ``(N*H*W, ldk)``. Fusing the
depthwise into the GEMM's A-tile load is later work. The TPU layout ``(H*W, B, C)`` and its batch
padding to 8 existed for the TPU's tiling and are not carried over: this
kernel works on NHWC at any N and H, and W up to 512.

Rounding points match ``_pos_kernel``: each rep's input is ReLU'd and rounded
to bf16; the 9 taps accumulate in fp32 dy-major; the sum is rounded to bf16
before the pointwise; the pointwise accumulates in fp32 and adds the bias;
only the last rep adds the block input, read in fp32 from the unrounded
input; each rep stores in ``x.dtype``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import load_library

PW_ROW_ALIGN = 32  # elements: the GEMM's operand rows start on 64-byte boundaries


def middle_block_ref(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, b: torch.Tensor):
    """Plain PyTorch version of K1 on NHWC ``x``; same rounding points.

    ``dw (reps, 9, C)`` fp32 taps (index ``dy*3+dx``), ``pw (reps, C, ldk)``
    ``[out, in]`` with ``ldk >= C`` (the first C columns used, as bf16
    values), ``b (reps, C)`` fp32.
    """
    N, H, W, C = x.shape
    reps = dw.shape[0]
    h = x
    for r in range(reps):
        a = torch.relu(h).to(torch.bfloat16).float()
        ap = F.pad(a, (0, 0, 1, 1, 1, 1))  # zero halo on W and H
        acc = None
        for dy in range(3):
            for dx in range(3):
                contrib = ap[:, dy : dy + H, dx : dx + W, :] * dw[r, dy * 3 + dx].float()
                acc = contrib if acc is None else acc + contrib
        a16 = acc.to(torch.bfloat16).float().reshape(N * H * W, C)
        o = a16 @ pw[r, :, :C].to(torch.bfloat16).float().t() + b[r].float()
        o = o.reshape(N, H, W, C)
        if r + 1 == reps:
            o = o + x.float()
        h = o.to(x.dtype)
    return h


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("middle_block")
    lib.mdfd_middle_block.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.mdfd_middle_block.restype = ctypes.c_int
    lib.mdfd_error_string.argtypes = [ctypes.c_int]
    lib.mdfd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dw, pw, b) -> None:
    if not x.is_cuda:
        raise ValueError(f"middle_block: x must be a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"middle_block: x must be (N, H, W, C) bf16/fp32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("middle_block: x must be NHWC-contiguous (channels_last)")
    N, H, W, C = x.shape
    reps, ldk = dw.shape[0], pw.shape[-1]
    if C % 8 or ldk % 8 or ldk < C:
        raise ValueError(f"middle_block: C={C} and pw's row length {ldk} >= C must be "
                         "multiples of 8 (16-byte rows)")
    if N * H * W >= 2**31:
        raise ValueError("middle_block: N*H*W must fit in int32")
    if W > 512:
        raise ValueError(f"middle_block: W={W} > 512 (the staged depthwise band outgrows "
                         "shared memory)")
    for name, t, shape, dtype in (
        ("dw", dw, (reps, 9, C), torch.float32),
        ("pw", pw, (reps, C, ldk), torch.bfloat16),
        ("b", b, (reps, C), torch.float32),
    ):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"middle_block: {name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"middle_block: {name} must be contiguous, 16-byte aligned "
                             f"and on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("middle_block: x must be 16-byte aligned")


def middle_block(x: torch.Tensor, dw: torch.Tensor, pw: torch.Tensor, b: torch.Tensor):
    """One middle-flow block on NHWC ``x`` -> same shape and dtype.

    A CPU tensor takes :func:`middle_block_ref`. A CUDA tensor launches the
    kernel or raises: there is no fallback. ``middle_block.launches`` counts
    kernel launches.
    """
    if x.device.type == "cpu":
        return middle_block_ref(x, dw, pw, b)
    _check(x, dw, pw, b)
    lib = _lib()
    N, H, W, C = x.shape
    ldk = pw.shape[-1]
    out = torch.empty_like(x)
    scratch = torch.empty((N * H * W, ldk), dtype=torch.bfloat16, device=x.device)
    err = lib.mdfd_middle_block(
        x.data_ptr(), dw.data_ptr(), pw.data_ptr(), b.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), N, H, W, C, ldk, dw.shape[0], int(x.dtype == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"middle_block kernel failed: {lib.mdfd_error_string(err).decode()}")
    middle_block.launches += 1
    return out


middle_block.launches = 0


def pack_middle_block(units) -> tuple:
    """Folded middle-block units -> the kernel's operands.

    ``units``: per rep ``(dw (C, 1, 3, 3), pw (C, C, 1, 1) [out, in], b (C,))``.
    Returns ``dw (reps, 9, C)`` fp32, ``pw (reps, C, ldk)`` bf16 ``[out, in]``
    (the 1x1 conv weight's own layout; the JAX packer's ``[in, out]``
    transposed, so the GEMM reads both operands K-major) with rows
    zero-padded to ``ldk = PW_ROW_ALIGN * ceil(C / PW_ROW_ALIGN)``, and
    ``b (reps, C)`` fp32, all contiguous.
    """
    dws, pws, bs = [], [], []
    for dw, pw, b in units:
        C = pw.shape[1]
        dws.append(dw.float().reshape(dw.shape[0], 9).t())
        pws.append(F.pad(pw[:, :, 0, 0], (0, -C % PW_ROW_ALIGN)))
        bs.append(b.float())
    return (
        torch.stack(dws).contiguous(),
        torch.stack(pws).to(torch.bfloat16).contiguous(),
        torch.stack(bs).contiguous(),
    )
