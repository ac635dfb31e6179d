"""int8 post-training-quantization primitives (the w8a8 serving path).

Counterpart of ``multimodal_deepfake_detection_tpu/ops/quant.py``. Scheme:
per-output-channel symmetric int8 weights (``s_w[o] = amax|w[o]|/127``), a
static calibrated activation scale ``s_in`` (scalar, or per input channel
when ``models/quant.py`` folds the activation scales into the weights, with
the scalar ``s_dq`` left for the epilogue), an exact int32 product, and one
dequant epilogue ``float(y) * (s_dq * s_w) + b``.

Weights are in PyTorch's layouts (conv OIHW, depthwise ``(C, 1, 3, 3)``),
activations NHWC as everywhere in the port. The 1x1 convs and the 3x3 stem
convs (an int8 im2col) run as GEMMs through ``torch._int_mm``: the JAX
package leaves them to XLA, outside any Pallas kernel. The int8 depthwise
runs on CUDA through the port's own kernel (``ops/kernels/dw_w8a8.py``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

QMAX = 127.0


def absmax_scale(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Symmetric int8 scale: amax(|x|)/127, floored away from zero."""
    a = x.float().abs()
    amax = a.amax() if dim is None else a.amax(dim=dim)
    return torch.clamp_min(amax, 1e-12) / QMAX


def quantize(x: torch.Tensor, scale) -> torch.Tensor:
    """Round half to even, symmetric int8. A divide, as in the JAX package:
    a multiply by the reciprocal flips codes at .5 ties."""
    return torch.clamp(torch.round(x.float() / scale), -QMAX, QMAX).to(torch.int8)


def quantize_weight(w: torch.Tensor):
    """Per-output-channel (axis 0 of OIHW) int8 -> ``(w_q int8, s_w fp32 (O,))``."""
    s_w = absmax_scale(w, dim=tuple(range(1, w.dim())))
    return quantize(w, s_w.view((-1,) + (1,) * (w.dim() - 1))), s_w


def _int_gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ w (N, K)^T`` in int8 -> exact int32 ``(M, N)``.

    cuBLASLt, behind ``torch._int_mm`` on CUDA, takes M > 16 and K, N
    multiples of 8: K pads with zero columns (conv1's 27 -> 32) and, on CUDA,
    small M with zero rows (the 1x1 exit flow of a 32^2 input has M = N; the
    CPU's ``_int_mm`` takes any M, so an exported program's symbolic batch
    meets no test of M there). Both pads add nothing to the sums.
    """
    M, K = a.shape
    pad_k = -K % 8
    pad_m = 32 - M if a.is_cuda and M <= 16 else 0
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
        w = F.pad(w, (0, pad_k))
    return torch._int_mm(a.contiguous(), w.contiguous().t())[:M]


def conv2d_w8a8(
    x: torch.Tensor,
    w_q: torch.Tensor,
    s_w: torch.Tensor,
    s_in: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    s_dq: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """NHWC int8 convolution with the dequant epilogue.

    ``w_q`` int8 OIHW (1x1, or k x k for the stem), ``s_w`` fp32 ``(O,)``,
    ``s_in`` fp32 scalar or ``(Ci,)``, ``s_dq`` fp32 scalar (defaults to
    ``s_in``), ``b`` fp32 ``(O,)`` or None. ``x`` is quantized with ``s_in``
    on the way in; the product is summed exactly in int32, then
    ``float(y) * (s_dq * s_w) + b`` is cast to ``out_dtype``.
    """
    s_dq = s_in if s_dq is None else s_dq
    xq = quantize(x, s_in)
    O, Ci, kh, kw = w_q.shape
    if padding:
        xq = F.pad(xq, (0, 0, padding, padding, padding, padding))
    N, Hp, Wp, _ = xq.shape
    Ho, Wo = (Hp - kh) // stride + 1, (Wp - kw) // stride + 1
    if kh == kw == 1:
        cols = xq[:, : (Ho - 1) * stride + 1 : stride, : (Wo - 1) * stride + 1 : stride, :]
        a, wm = cols.reshape(N * Ho * Wo, Ci), w_q.reshape(O, Ci)
    else:  # int8 im2col, K ordered (dy, dx, ci)
        taps = [
            xq[:, dy : dy + (Ho - 1) * stride + 1 : stride, dx : dx + (Wo - 1) * stride + 1 : stride, :]
            for dy in range(kh)
            for dx in range(kw)
        ]
        a = torch.stack(taps, dim=3).reshape(N * Ho * Wo, kh * kw * Ci)
        wm = w_q.permute(0, 2, 3, 1).reshape(O, kh * kw * Ci)
    y = _int_gemm(a, wm).reshape(N, Ho, Wo, O)
    out = y.float() * (s_dq * s_w)
    if b is not None:
        out = out + b
    return out.to(out_dtype)


def depthwise_conv2d_w8a8(
    x: torch.Tensor,
    w_q: torch.Tensor,
    s_w: torch.Tensor,
    s_in: torch.Tensor,
    s_dq: Optional[torch.Tensor] = None,
    *,
    out_dtype: torch.dtype = torch.bfloat16,
    use_kernels: bool = True,
) -> torch.Tensor:
    """NHWC int8 depthwise 3x3 (stride 1, pad 1) with the dequant epilogue,
    no bias: ``float(y) * (s_dq * s_w)``. A per-channel ``s_in`` folds onto
    the output channel, where ``s_w`` absorbed it.

    With ``use_kernels`` the call goes to ``ops/kernels/dw_w8a8.py``'s
    wrapper (the CUDA kernel on a CUDA tensor, its plain version on a CPU
    one); without, to the plain version on any device.
    """
    from .kernels.dw_w8a8 import dw_w8a8, dw_w8a8_ref  # the kernel module imports this one

    sc = (s_in if s_dq is None else s_dq) * s_w
    return (dw_w8a8 if use_kernels else dw_w8a8_ref)(x, w_q, s_in, sc, out_dtype)


def dequant_error(w: torch.Tensor) -> float:
    """Max abs reconstruction error of per-channel int8 on ``w`` (diagnostics)."""
    w_q, s_w = quantize_weight(w)
    s = s_w.view((-1,) + (1,) * (w.dim() - 1))
    return float((w_q.float() * s - w.float()).abs().max())
