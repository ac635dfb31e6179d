"""Plain PyTorch pieces shared by the kernels' plain versions, packers and
wrappers (K1, K3, K4, K5): the depthwise in each kernel's tap order, the
pointwise at the kernels' rounding points, weight packing and operand checks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PW_ROW_ALIGN = 32  # elements: the GEMM's operand rows start on 64-byte boundaries
TAP_ORDERS = ("dy", "cols", "bf16")


def depthwise3x3_ref(a: torch.Tensor, taps: torch.Tensor, order: str = "dy") -> torch.Tensor:
    """Zero-padded 3x3 depthwise of NHWC ``a`` with ``taps (9, C)`` (index
    ``dy*3+dx``), in the order the kernels sum it:

    - ``"dy"``: fp32 products summed dy-major (K1, K2, K5, K4's stream kernels);
    - ``"cols"``: fp32 products summed per column over dy, then
      ``(dx0 + dx1) + dx2`` (K3, K4's ``entry_pair_pallas``);
    - ``"bf16"``: taps, each product and each running sum rounded to bf16,
      dy-major (``middle_block_pallas_v2(precise=False)``).

    Returns fp32 (bf16 values for ``"bf16"``).
    """
    if order not in TAP_ORDERS:
        raise ValueError(f"tap order must be one of {TAP_ORDERS}, got {order!r}")
    _, H, W, _ = a.shape
    dtype = torch.bfloat16 if order == "bf16" else torch.float32
    ap = F.pad(a.to(dtype), (0, 0, 1, 1, 1, 1))  # zero halo on W and H
    t = taps.to(dtype)
    tap = lambda dy, dx: ap[:, dy : dy + H, dx : dx + W, :] * t[dy * 3 + dx]
    if order == "cols":
        cols = []
        for dx in range(3):
            s = tap(0, dx)
            for dy in (1, 2):
                s = s + tap(dy, dx)
            cols.append(s)
        return (cols[0] + cols[1]) + cols[2]
    acc = None
    for dy in range(3):
        for dx in range(3):
            p = tap(dy, dx)
            acc = p if acc is None else acc + p
    return acc.float()


def pointwise_ref(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """NHWC fp32 ``a`` (bf16 values) @ the first K columns of ``w (N, ldk)``
    as bf16 values, + ``b``, in fp32."""
    K = a.shape[-1]
    o = a.reshape(-1, K) @ w[:, :K].to(torch.bfloat16).float().t() + b.float()
    return o.reshape(*a.shape[:-1], -1)


def pad_rows(w: torch.Tensor) -> torch.Tensor:
    """``[out, in]`` -> bf16 with rows zero-padded to a multiple of PW_ROW_ALIGN."""
    return F.pad(w, (0, -w.shape[1] % PW_ROW_ALIGN)).to(torch.bfloat16).contiguous()


def dw_taps(dw: torch.Tensor) -> torch.Tensor:
    """Depthwise weight ``(C, 1, 3, 3)`` -> fp32 taps ``(9, C)``, index ``dy*3+dx``."""
    return dw.float().reshape(dw.shape[0], 9).t().contiguous()


def check_x(kernel: str, x: torch.Tensor) -> None:
    """The activation a kernel takes: NHWC-contiguous bf16/fp32 on CUDA,
    16-byte aligned, N*H*W within int32 (any H and W)."""
    if not x.is_cuda:
        raise ValueError(f"{kernel}: x must be a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{kernel}: x must be (N, H, W, C) bf16/fp32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{kernel}: x must be NHWC-contiguous (channels_last) and 16-byte "
                         "aligned")
    N, H, W, _ = x.shape
    if N * H * W >= 2**31:
        raise ValueError(f"{kernel}: N*H*W must fit in int32")


def check_operands(kernel: str, x: torch.Tensor, specs) -> None:
    """``specs``: ``(name, tensor, shape, dtype)`` of each weight operand; each
    must match and be contiguous, 16-byte aligned and on x's device."""
    for name, t, shape, dtype in specs:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{kernel}: {name} must be {tuple(shape)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be contiguous, 16-byte aligned "
                             f"and on {x.device}")


def check_widths(kernel: str, **widths: int) -> None:
    """Channel counts and row lengths must be multiples of 8 (16-byte rows)."""
    for name, v in widths.items():
        if v % 8:
            raise ValueError(f"{kernel}: {name} = {v} must be a multiple of 8 (16-byte rows)")
