"""K2: the Xception middle-flow block with an int8 pointwise, as a hand-written Hopper kernel.

Replaces ``multimodal_deepfake_detection_tpu/ops/pallas/sepconv_pos.py::
middle_block_pos_pallas_w8`` (``_pos_q_kernel``), with weights packed as
``sepconv_pos.py::pack_middle_block_q``. Source: ``csrc/middle_block_w8.cu``
(CUDA C++, ``sm_90a``), built by ``_build.py`` and bound through ``ctypes``.

What bounds it on an H100, at 256 frames of 16x16x728: the three int8
GEMMs, 3 x 2 x 65,536 x 728^2 = 208.4 G operations at 1,979 TOPS, 0.105 ms;
reading the block's input and writing its output once is 190.8 MB, 0.057 ms
at 3.35 TB/s. The design is K1's two launches per rep with int8 operands:
the depthwise kernel (K1's, in ``csrc/sm90_common.cuh``) writes the int8
codes of the GEMM operand, then K1's persistent GEMM (``csrc/bf16_gemm.cuh``,
one CTA per SM, a TMA ring across tiles) runs ``wgmma`` s8 and an epilogue
that applies the dequant scale and the bias, adds the residual on the last
rep and stores through shared memory by TMA. With the operand through device
memory the block's floor is 0.290 ms. Both int8 operands have rows padded to 64 bytes (``ldk`` = 768 at C = 728):
TMA needs 16-byte row strides, and 64-byte row starts load faster.

Rounding points match ``_pos_q_kernel``: each rep's input is ReLU'd and
rounded to bf16; the taps, divided by the pointwise input scale ``s_in``
once per call, accumulate in fp32 dy-major, so the sum is in quantized
units; it is rounded half to even and clipped to +-127; the int8 product is
exact in int32; then ``float(y) * (s_dq * s_w) + b``; only the last rep adds
the block input, in fp32 from the unrounded input; each rep stores in
``x.dtype``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import launch, load_library, op_device

PW_ROW_ALIGN = 64  # bytes of int8: the GEMM's operand rows start on 64-byte boundaries


def _scaled(dw, s_w, s_in, s_dq):
    """The wrapper's two fp32 ops (``sepconv_pos.py:237-239``): the taps in
    quantized units and the per-rep dequant scale."""
    reps = dw.shape[0]
    taps = dw.float() / s_in.float().reshape(reps, 1, -1)
    sc = s_dq.float().reshape(reps, 1) * s_w.float()
    return taps.contiguous(), sc.contiguous()


def middle_block_w8_ref(x, dw, pw_q, s_w, s_in, s_dq, b):
    """Plain PyTorch version of K2 on NHWC ``x``; same rounding points.

    ``dw (reps, 9, C)`` fp32 taps (index ``dy*3+dx``), ``pw_q (reps, C, ldk)``
    int8 ``[out, in]`` with ``ldk >= C`` (the first C columns used),
    ``s_w``, ``s_in``, ``b`` ``(reps, C)`` fp32, ``s_dq (reps,)`` fp32.
    """
    N, H, W, C = x.shape
    taps, sc = _scaled(dw, s_w, s_in, s_dq)
    h = x
    for r in range(dw.shape[0]):
        a = torch.relu(h).to(torch.bfloat16).float()
        ap = F.pad(a, (0, 0, 1, 1, 1, 1))  # zero halo on W and H
        acc = None
        for dy in range(3):
            for dx in range(3):
                contrib = ap[:, dy : dy + H, dx : dx + W, :] * taps[r, dy * 3 + dx]
                acc = contrib if acc is None else acc + contrib
        q = torch.clamp(torch.round(acc), -127.0, 127.0).reshape(N * H * W, C)
        # the int8 product in fp64: every partial sum is an integer far below
        # 2^53, so this is the exact int32 result on any device
        y = q.double() @ pw_q[r, :, :C].double().t()
        o = (y.float() * sc[r] + b[r].float()).reshape(N, H, W, C)
        if r + 1 == dw.shape[0]:
            o = o + x.float()
        h = o.to(x.dtype)
    return h


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("middle_block_w8")
    lib.mdfd_middle_block_w8.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.mdfd_middle_block_w8.restype = ctypes.c_int
    lib.mdfd_error_string.argtypes = [ctypes.c_int]
    lib.mdfd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dw, pw_q, s_w, s_in, s_dq, b) -> None:
    if not x.is_cuda:
        raise ValueError(f"middle_block_w8: x must be a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"middle_block_w8: x must be (N, H, W, C) bf16/fp32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("middle_block_w8: x must be NHWC-contiguous (channels_last) and "
                         "16-byte aligned")
    N, H, W, C = x.shape
    reps, ldk = dw.shape[0], pw_q.shape[-1]
    if C % 8 or ldk % 16 or ldk < C:
        raise ValueError(f"middle_block_w8: C={C} must be a multiple of 8 and pw_q's row "
                         f"length {ldk} >= C a multiple of 16")
    if N * H * W >= 2**31:
        raise ValueError("middle_block_w8: N*H*W must fit in int32")
    for name, t, shape, dtype in (
        ("dw", dw, (reps, 9, C), torch.float32),
        ("pw_q", pw_q, (reps, C, ldk), torch.int8),
        ("s_w", s_w, (reps, C), torch.float32),
        ("s_in", s_in, (reps, C), torch.float32),
        ("s_dq", s_dq, (reps,), torch.float32),
        ("b", b, (reps, C), torch.float32),
    ):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"middle_block_w8: {name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"middle_block_w8: {name} must be contiguous, 16-byte aligned "
                             f"and on {x.device}")


def launch_middle_block_w8(x, dw, pw_q, s_w, s_in, s_dq, b) -> torch.Tensor:
    """The CUDA implementation of ``mdfd::middle_block_w8``: launches the
    kernel (or raises) and counts the launch."""
    _check(x, dw, pw_q, s_w, s_in, s_dq, b)
    lib = _lib()
    N, H, W, C = x.shape
    ldk = pw_q.shape[-1]
    taps, sc = _scaled(dw, s_w, s_in, s_dq)
    out = torch.empty_like(x)
    scratch = torch.empty((N * H * W, ldk), dtype=torch.int8, device=x.device)
    launch(lib, "mdfd_middle_block_w8", x,
           x.data_ptr(), taps.data_ptr(), pw_q.data_ptr(), sc.data_ptr(), b.data_ptr(),
           out.data_ptr(), scratch.data_ptr(), N, H, W, C, ldk, dw.shape[0],
           int(x.dtype == torch.float32))
    middle_block_w8.launches += 1
    return out


def middle_block_w8(x, dw, pw_q, s_w, s_in, s_dq, b):
    """One int8-pointwise middle-flow block on NHWC ``x`` -> same shape and
    dtype, through the custom op ``torch.ops.mdfd.middle_block_w8``.

    Operands as :func:`middle_block_w8_ref`. A CPU tensor takes the plain
    version. A CUDA tensor launches the kernel or raises: there is no
    fallback. ``middle_block_w8.launches`` counts kernel launches.
    """
    if op_device(x):
        return torch.ops.mdfd.middle_block_w8(x, dw, pw_q, s_w, s_in, s_dq, b)
    return launch_middle_block_w8(x, dw, pw_q, s_w, s_in, s_dq, b)


middle_block_w8.launches = 0


def is_middle_block_q(block) -> bool:
    """``is_middle_block`` for quantized blocks: no projection, every
    pointwise an int8 C -> C weight (stride and the leading ReLU are the
    caller's to check, as in ``sepconv_pos.py::is_middle_block_q``)."""
    if block.skip is not None:
        return False
    if not all(u.pointwise.quantized for u in block.units):
        return False
    c = block.units[0].pointwise.w_q.shape[0]
    return all(tuple(u.pointwise.w_q.shape[:2]) == (c, c) for u in block.units)


def pack_middle_block_q(units) -> tuple:
    """Quantized middle-block units (``models/quant.py`` nodes) -> K2's operands.

    Returns ``dw (reps, 9, C)`` fp32, ``pw_q (reps, C, ldk)`` int8 ``[out,
    in]`` (the 1x1 conv's own layout; the JAX packer's ``[in, out]``
    transposed) with rows zero-padded to ``ldk = 64 * ceil(C / 64)``,
    ``s_w (reps, C)``, ``s_in (reps, C)`` (a scalar broadcast), ``s_dq
    (reps,)`` (``s_in`` where the node has none) and ``b (reps, C)``, all fp32
    and contiguous.

    A quantized depthwise node is dequantized (the kernel's taps run in
    fp32 either way). With per-channel activation scales its ``w_q * s_w``
    is the folded weight ``w * s_fold[c]``, so the fold is undone with the
    depthwise node's own ``s_dq / s_in`` (``sepconv_pos.py:275-284``);
    without that, every channel's tap is off by its fold factor.
    """
    dws, pws, sws, sins, sdqs, bs = [], [], [], [], [], []
    for u in units:
        d, p = u.depthwise, u.pointwise
        if d.quantized:
            w = d.w_q.float() * d.s_w.view(-1, 1, 1, 1)
            if d.s_dq is not None:
                w = w * (d.s_dq / d.s_in.float()).reshape(-1, 1, 1, 1)
        else:
            w = d.w.float()
        C = p.w_q.shape[0]
        dws.append(w.reshape(w.shape[0], 9).t())
        pws.append(F.pad(p.w_q[:, :, 0, 0], (0, -C % PW_ROW_ALIGN)))
        sws.append(p.s_w.float())
        sins.append(p.s_in.float().reshape(-1).expand(C))
        sdqs.append((p.s_in if p.s_dq is None else p.s_dq).float().reshape(()))
        bs.append(p.b.float())
    return tuple(torch.stack(t).contiguous() for t in (dws, pws, sws, sins, sdqs, bs))
