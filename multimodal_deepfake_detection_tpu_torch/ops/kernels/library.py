"""The kernels as ``torch.library`` custom ops in the namespace ``mdfd``.

Each op has three implementations: on the CPU the kernel's plain PyTorch
version, on CUDA the wrapper module's ``launch_*`` (it launches the kernel or
raises, and counts the launch in the wrapper's ``.launches``), and a fake
one that gives the output's shape and dtype, so ``torch.export`` keeps each
op as one node of its graph and an exported program launches the kernel
when it replays on the card. Tracing runs the fake implementation only and
counts nothing.

===================  ======================================  ===========================
op                   kernel                                  public wrapper
===================  ======================================  ===========================
``middle_block``     K1 (``taps`` "fp32" or "bf16")          ``middle_block.middle_block``
``middle_block_w8``  K2                                      ``middle_block_w8``
``dw_w8a8``          the int8 depthwise                      ``dw_w8a8.dw_w8a8``
``entry_block``      K3                                      ``entry_block.entry_block``
``entry_pair``       K4 (``col_sums``, ``mid_fp32``)         ``entry_pair.entry_pair``
``sepconv_unit``     K5                                      ``sepconv_unit.sepconv_unit``
===================  ======================================  ===========================

The CUDA implementations look up the module's ``launch_*`` at each call, so
a test that replaces a module's loader or checks sees the op take it.
``ops/kernels/__init__.py`` imports this module: importing any kernel
module registers every op, and so does ``models/export.py`` before it loads
a program.
"""
from __future__ import annotations

import torch
from torch import Tensor
from torch.library import custom_op

from . import dw_w8a8 as _dw
from . import entry_block as _k3
from . import entry_pair as _k4
from . import middle_block as _k1
from . import middle_block_w8 as _k2
from . import sepconv_unit as _k5

NAMESPACE = "mdfd"


@custom_op("mdfd::middle_block", mutates_args=(), device_types="cpu")
def middle_block(x: Tensor, dw: Tensor, pw: Tensor, b: Tensor, taps: str) -> Tensor:
    return _k1.middle_block_ref(x, dw, pw, b, taps=taps)


@middle_block.register_kernel("cuda")
def _(x, dw, pw, b, taps):
    return _k1.launch_middle_block(x, dw, pw, b, taps)


@middle_block.register_fake
def _(x, dw, pw, b, taps):
    return x.new_empty(x.shape)


@custom_op("mdfd::middle_block_w8", mutates_args=(), device_types="cpu")
def middle_block_w8(x: Tensor, dw: Tensor, pw_q: Tensor, s_w: Tensor, s_in: Tensor,
                    s_dq: Tensor, b: Tensor) -> Tensor:
    return _k2.middle_block_w8_ref(x, dw, pw_q, s_w, s_in, s_dq, b)


@middle_block_w8.register_kernel("cuda")
def _(x, dw, pw_q, s_w, s_in, s_dq, b):
    return _k2.launch_middle_block_w8(x, dw, pw_q, s_w, s_in, s_dq, b)


@middle_block_w8.register_fake
def _(x, dw, pw_q, s_w, s_in, s_dq, b):
    return x.new_empty(x.shape)


@custom_op("mdfd::dw_w8a8", mutates_args=(), device_types="cpu")
def dw_w8a8(x: Tensor, w_q: Tensor, s_in: Tensor, sc: Tensor, out_dtype: torch.dtype) -> Tensor:
    return _dw.dw_w8a8_ref(x, w_q, s_in, sc, out_dtype)


@dw_w8a8.register_kernel("cuda")
def _(x, w_q, s_in, sc, out_dtype):
    return _dw.launch_dw_w8a8(x, w_q, s_in, sc, out_dtype)


@dw_w8a8.register_fake
def _(x, w_q, s_in, sc, out_dtype):
    return x.new_empty(x.shape, dtype=out_dtype)


@custom_op("mdfd::entry_block", mutates_args=(), device_types="cpu")
def entry_block(x: Tensor, dw0: Tensor, pw0: Tensor, b0: Tensor, dw1: Tensor, pw1: Tensor,
                b1: Tensor, skw: Tensor, skb: Tensor, leading_relu0: bool) -> Tensor:
    return _k3.entry_block_ref(x, dw0, pw0, b0, dw1, pw1, b1, skw, skb,
                               leading_relu0=leading_relu0)


@entry_block.register_kernel("cuda")
def _(x, dw0, pw0, b0, dw1, pw1, b1, skw, skb, leading_relu0):
    return _k3.launch_entry_block(x, dw0, pw0, b0, dw1, pw1, b1, skw, skb, leading_relu0)


@entry_block.register_fake
def _(x, dw0, pw0, b0, dw1, pw1, b1, skw, skb, leading_relu0):
    N, H, W, _ = x.shape
    return x.new_empty((N, (H + 1) // 2, (W + 1) // 2, pw1.shape[0]))


@custom_op("mdfd::entry_pair", mutates_args=(), device_types="cpu")
def entry_pair(x: Tensor, dw0: Tensor, pw0: Tensor, b0: Tensor, dw1: Tensor, pw1: Tensor,
               b1: Tensor, leading_relu0: bool, col_sums: bool, mid_fp32: bool) -> Tensor:
    return _k4.entry_pair_ref(x, dw0, pw0, b0, dw1, pw1, b1, leading_relu0=leading_relu0,
                              col_sums=col_sums, mid_fp32=mid_fp32)


@entry_pair.register_kernel("cuda")
def _(x, dw0, pw0, b0, dw1, pw1, b1, leading_relu0, col_sums, mid_fp32):
    return _k4.launch_entry_pair(x, dw0, pw0, b0, dw1, pw1, b1, leading_relu0, col_sums,
                                 mid_fp32)


@entry_pair.register_fake
def _(x, dw0, pw0, b0, dw1, pw1, b1, leading_relu0, col_sums, mid_fp32):
    return x.new_empty(tuple(x.shape[:3]) + (pw1.shape[0],))


@custom_op("mdfd::sepconv_unit", mutates_args=(), device_types="cpu")
def sepconv_unit(x: Tensor, dw: Tensor, pw: Tensor, b: Tensor, leading_relu: bool,
                 trailing_relu: bool) -> Tensor:
    return _k5.sepconv_unit_ref(x, dw, pw, b, leading_relu=leading_relu,
                                trailing_relu=trailing_relu)


@sepconv_unit.register_kernel("cuda")
def _(x, dw, pw, b, leading_relu, trailing_relu):
    return _k5.launch_sepconv_unit(x, dw, pw, b, leading_relu, trailing_relu)


@sepconv_unit.register_fake
def _(x, dw, pw, b, leading_relu, trailing_relu):
    return x.new_empty(tuple(x.shape[:3]) + (pw.shape[0],))


def kernel_counter(node) -> str:
    """The launch counter an ``mdfd`` node of an exported graph adds to when
    it replays on the card: the op's name, ``middle_block_bf16taps`` for K1
    with ``taps="bf16"``; ``""`` for any other node."""
    target = getattr(node, "target", None)
    if not isinstance(target, torch._ops.OpOverload) or target.namespace != NAMESPACE:
        return ""
    name = target.name().split("::")[1]
    if name == "middle_block" and node.args[4] == "bf16":
        return "middle_block_bf16taps"
    return name
