"""Operations and bytes of the configurations' work, counted from shapes, and
the table of peaks they are held against.

Conv and matmul operations count a multiply and an add as 2, as
``bench.py::xception_net_flops`` of the JAX package does (this module is
its port to the configuration's block table; a CPU test holds the two
equal). Pools, adds, activations and the MFCC's FFT are not counted.
"""
from __future__ import annotations

from typing import Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _conv(h: int, cin: int, cout: int, k: int = 1, groups: int = 1) -> int:
    return h * h * (cin // groups) * cout * k * k * 2


def _units(row):
    cin, cout, reps, _, _, grow_first = row
    if grow_first:
        return [(cin, cout)] + [(cout, cout)] * (reps - 1)
    return [(cin, cin)] * (reps - 1) + [(cin, cout)]


def _pooled(h: int, stride: int) -> int:
    return (h + 2 - 3) // stride + 1  # 3x3 max pool, padding 1


def stem_size(size: int) -> int:
    """Side of the stem's output: conv1 3x3/2 then conv2 3x3, both unpadded."""
    return (size - 3) // 2 + 1 - 2


def xception_flops(cfg: dict, images: int, size: int) -> int:
    """Conv operations of the Xception features of ``images`` images of
    ``size`` squared (no fc)."""
    h = (size - 3) // 2 + 1
    total = _conv(h, 3, 32, 3)
    h -= 2
    total += _conv(h, 32, 64, 3)
    c = 64
    for row in cfg["xception_blocks"]["rows"]:
        stride, cout = row[3], row[1]
        for ci, co in _units(row):
            total += _conv(h, ci, ci, 3, groups=ci) + _conv(h, ci, co)
        if stride != 1:
            h = _pooled(h, stride)
            total += _conv(h, c, cout)  # the projection skip
        c = cout
    for ci, co in cfg["xception_blocks"]["exit"]:
        total += _conv(h, ci, ci, 3, groups=ci) + _conv(h, ci, co)
    return total * images


def trunk_size(cfg: dict, size: int) -> int:
    """Side of the middle flow's feature maps."""
    h = stem_size(size)
    for row in cfg["xception_blocks"]["rows"]:
        if row[3] != 1:
            h = _pooled(h, row[3])
        if row[0] == row[1] and row[3] == 1:
            return h
    raise ValueError("the block table has no middle flow")


def middle_blocks(cfg: dict) -> list:
    return [r for r in cfg["xception_blocks"]["rows"] if r[0] == r[1] and r[3] == 1]


def middle_flow(cfg: dict, images: int, size: int, elem_bytes: int = 2) -> Tuple[int, int]:
    """Operations and bytes of the middle flow over ``images`` images: every
    depthwise and pointwise conv of its blocks; the stage's input read once,
    its output written once and each weight (taps, pointwise, folded bias)
    read once, in the compute dtype."""
    h = trunk_size(cfg, size)
    ops, weights, c = 0, 0, None
    for row in middle_blocks(cfg):
        for ci, co in _units(row):
            ops += _conv(h, ci, ci, 3, groups=ci) + _conv(h, ci, co)
            weights += ci * 9 + ci * co + co
            c = co
    activations = 2 * images * h * h * c
    return ops * images, (activations + weights) * elem_bytes


def least_seconds(ops: float, nbytes: float) -> Tuple[float, str]:
    """The least time on the card: the larger of operations over the bf16
    peak and bytes over HBM bandwidth, and which of the two bounds it."""
    by_ops, by_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def lstm_flops(clips: int, steps: int, feature_dim: int, hidden: int) -> int:
    """The input projection of every step and the recurrent matmul."""
    return clips * steps * (feature_dim + hidden) * 4 * hidden * 2


def head_flops(cfg: dict, clips: int) -> int:
    """ArcFace's cosines, or the MLP head's four layers and output."""
    H = cfg["hidden_dim"]
    if "arcface_s" in cfg:
        return clips * H * cfg["num_classes"] * 2
    M = cfg["mlp_width"]
    return clips * (H * M + 3 * M * M + M) * 2


def score_flops(cfg: dict, clips: int, steps: int) -> int:
    """One ``score()`` call of ``clips`` clips padded to ``steps`` images
    each: the backbone over every image the device computes, the LSTM over
    every step, the head."""
    return (xception_flops(cfg, clips * steps, cfg["image_size"])
            + lstm_flops(clips, steps, cfg["feature_dim"], cfg["hidden_dim"])
            + head_flops(cfg, clips))
