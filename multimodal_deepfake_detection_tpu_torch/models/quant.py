"""w8a8 post-training-quantized Xception serving forward.

Counterpart of the Xception half of ``multimodal_deepfake_detection_tpu/
models/quant.py``. The BN-folded network is held as a tree of conv sites
(:class:`QuantizedXception`), each site fp (``w [, b]``) or int8 (``w_q``,
``s_w``, ``s_in`` [, ``s_dq``] [, ``b``]). Every regular and pointwise conv
of a quantized tree runs as an int8 GEMM with per-output-channel weight
scales and a static activation scale calibrated offline; with
``quant_depthwise`` the depthwise 3x3s are int8 too; the fc head stays fp.

One structural walk, :func:`xception_quant_walk`, serves every mode, so the
calibration pass, the fp pass and the quantized pass cannot drift apart:

* ``observe=True``: the fp forward that also returns each site's input
  amax per channel;
* ``quant=False``: the plain fp folded forward (equals
  ``FoldedXception.forward``, pinned by a test);
* ``quant=True``: the w8a8 forward over a tree from
  :func:`quantize_folded_xception`.

``fuse_middle`` (the JAX walk's ``middle_pallas``) runs each middle-flow
block as one fused block: K2 (``ops/kernels/middle_block_w8.py``) on int8
blocks, K1 (``ops/kernels/middle_block.py``) on fp ones, as a
``skip_middle`` tree has them. ``use_kernels`` sends those blocks and the
int8 depthwise through the kernel wrappers (the kernels on CUDA, their plain
versions on the CPU); ``use_kernels=False`` takes the plain versions on any
device. The JAX walk's W >= 4 gate on its fused kernels works around a TPU
fault and is not ported: K1 and K2 are exact at any trunk size.

The walk's ``tap``/``shadow`` hooks report every conv site's output, and,
with a shadow tree, that tree's node applied to the same input beside it;
:func:`refine_quantized_xception` fits a per-channel affine correction of a
w8a8 tree on them.

The ResNet-18 half (the AU models' backbone) follows the same scheme over a
:class:`QuantizedResNet18`: :func:`resnet18_quant_walk` with the same modes
and hooks, :func:`calibrate_resnet18_amax`, :func:`quantize_folded_resnet18`
and :func:`refine_quantized_resnet18`. Every one of its convs, the 7x7 stem
included, is int8 through ``conv2d_w8a8`` (an int8 im2col GEMM); none goes
through a kernel of the port's own, as none of the JAX package's goes
through a Pallas kernel.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops.conv import conv2d, global_avg_pool, linear, max_pool2d
from ..ops.kernels.middle_block import middle_block, middle_block_ref, pack_middle_block
from ..ops.kernels.middle_block_w8 import (
    is_middle_block_q,
    middle_block_w8,
    middle_block_w8_ref,
    pack_middle_block_q,
)
from ..ops.quant import conv2d_w8a8, depthwise_conv2d_w8a8, quantize_weight
from .fold import FoldedResNet18, FoldedXception
from .xception import XCEPTION_BLOCK_SPECS

NODE_KEYS = ("w", "b", "w_q", "s_w", "s_in", "s_dq")


class ConvNode(nn.Module):
    """One conv site: fp (``w`` OIHW [, ``b``]) or int8 (``w_q`` int8 OIHW,
    ``s_w (O,)``, ``s_in`` scalar or ``(Ci,)`` [, ``s_dq`` scalar] [, ``b``]),
    all as buffers; absent ones are None."""

    def __init__(self, **tensors: Optional[torch.Tensor]):
        super().__init__()
        unknown = set(tensors) - set(NODE_KEYS)
        if unknown:
            raise ValueError(f"unknown conv-node fields {sorted(unknown)}")
        for k in NODE_KEYS:
            self.register_buffer(k, tensors.get(k))

    @property
    def quantized(self) -> bool:
        return self.w_q is not None

    def fields(self) -> Dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in NODE_KEYS if getattr(self, k) is not None}


class SepNode(nn.Module):
    """A separable conv site: depthwise 3x3 then pointwise 1x1."""

    def __init__(self, depthwise: ConvNode, pointwise: ConvNode):
        super().__init__()
        self.depthwise = depthwise
        self.pointwise = pointwise


class QuantBlock(nn.Module):
    """One Xception block of the tree. A middle-flow block (stride 1,
    leading ReLU, no projection, square pointwise) also keeps its weights
    packed for its fused kernel: K1's operands when its nodes are fp, K2's
    when its pointwise is int8."""

    def __init__(self, spec, units, skip: Optional[ConvNode]):
        super().__init__()
        _in, _out, _reps, self.stride, self.start_with_relu, _grow = spec
        self.units = nn.ModuleList(units)
        self.skip = skip
        square = all(
            tuple((u.pointwise.w_q if u.pointwise.quantized else u.pointwise.w).shape[:2])
            == (_out, _out) for u in units
        )
        middle = self.stride == 1 and self.start_with_relu and skip is None and square
        self.k1 = middle and not any(u.pointwise.quantized or u.depthwise.quantized for u in units)
        self.k2 = middle and is_middle_block_q(self)
        packed = ()
        if self.k1:
            packed = pack_middle_block([(u.depthwise.w, u.pointwise.w, u.pointwise.b) for u in units])
        elif self.k2:
            packed = pack_middle_block_q(units)
        self.n_packed = len(packed)
        for i, t in enumerate(packed):
            self.register_buffer(f"packed_{i}", t)

    def packed_operands(self) -> tuple:
        """The fused kernel's operands, as ``pack_middle_block(_q)`` returned them."""
        return tuple(getattr(self, f"packed_{i}") for i in range(self.n_packed))


class QuantizedXception(nn.Module):
    """The Xception tree of conv sites that :func:`xception_quant_walk`
    runs. Built by :meth:`from_folded` with every site fp (the fp32 folded
    weights that calibration and the quantizer read), or by
    :func:`quantize_folded_xception` with int8 sites. ``fc_w (out, in)``,
    ``fc_b`` stay fp (None without an fc head)."""

    def __init__(self, conv1, conv2, blocks, conv3, conv4, fc_w=None, fc_b=None):
        super().__init__()
        self.conv1, self.conv2 = conv1, conv2
        self.blocks = nn.ModuleList(blocks)
        self.conv3, self.conv4 = conv3, conv4
        self.register_buffer("fc_w", fc_w)
        self.register_buffer("fc_b", fc_b)

    @classmethod
    def from_folded(cls, folded: FoldedXception) -> "QuantizedXception":
        """The all-fp tree of a folded module (fold it in fp32 for the quantizer)."""
        def sep(s):
            return SepNode(ConvNode(w=s.dw), ConvNode(w=s.pw, b=s.b))

        blocks = []
        for spec, fb in zip(XCEPTION_BLOCK_SPECS, folded.blocks):
            skip = None if fb.skip_w is None else ConvNode(w=fb.skip_w, b=fb.skip_b)
            blocks.append(QuantBlock(spec, [sep(u) for u in fb.units], skip))
        return cls(ConvNode(w=folded.conv1_w, b=folded.conv1_b),
                   ConvNode(w=folded.conv2_w, b=folded.conv2_b), blocks,
                   sep(folded.conv3), sep(folded.conv4), folded.fc_w, folded.fc_b)


def _sites(tree: QuantizedXception, *, depthwise: bool = False) -> Iterator[str]:
    """Walk-order keys of every conv site (13 blocks' units and skips, the
    stem, the two exit sepconvs)."""
    yield "conv1"
    yield "conv2"
    for k, blk in enumerate(tree.blocks):
        for i in range(len(blk.units)):
            if depthwise:
                yield f"blocks/{k}/units/{i}/depthwise"
            yield f"blocks/{k}/units/{i}/pointwise"
        if blk.skip is not None:
            yield f"blocks/{k}/skip"
    for site in ("conv3", "conv4"):
        if depthwise:
            yield f"{site}/depthwise"
        yield f"{site}/pointwise"


def _resolve_site(tree: nn.Module, site: str) -> nn.Module:
    """Walk-order site key ('blocks/3/units/1/pointwise', 'conv1', ...) -> node."""
    node = tree
    for part in site.split("/"):
        node = node[int(part)] if part.isdigit() else getattr(node, part)
    return node


def xception_quant_walk(
    tree: QuantizedXception,
    x: torch.Tensor,
    *,
    quant: bool = False,
    observe: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
    features_only: bool = False,
    fuse_middle: bool = False,
    use_kernels: bool = True,
    upto: Optional[str] = None,
    tap: Optional[Callable] = None,
    shadow: Optional[QuantizedXception] = None,
):
    """The shared structural forward on NHWC images (modes: module
    docstring). ``upto`` ("stem", "block<k>", "exit") returns that stage's
    output, as ``FoldedXception.forward`` does. With ``observe`` returns
    ``(out, {site: fp32 (Ci,) amax})``.

    ``tap(site, y)`` is called with every conv site's output (before its
    ReLU, after its bias; a depthwise under ``.../depthwise``); not with
    ``fuse_middle``, whose fused blocks expose no site. With a ``shadow``
    tree of the same structure, each site's shadow node is also applied to
    the same input and ``tap(site, y, y_shadow)`` is called; the walk goes
    on with its own output."""
    if tap is not None and fuse_middle:
        raise ValueError("tap= needs the unfused walk (fuse_middle=False): the fused blocks "
                         "expose no per-site outputs")
    if shadow is not None and tap is None:
        raise ValueError("shadow= needs a tap= to report the paired outputs to")
    obs = {} if observe else None

    def amax(site, h):
        if obs is not None:
            obs[site] = h.float().abs().amax(dim=(0, 1, 2))

    def apply_conv(node, h, stride, padding, q):
        if q and node.quantized:  # mixed trees carry fp nodes (skip_middle)
            return conv2d_w8a8(h, node.w_q, node.s_w, node.s_in, node.b, node.s_dq,
                               stride=stride, padding=padding, out_dtype=compute_dtype)
        return conv2d(h, node.w, node.b, stride=stride, padding=padding,
                      compute_dtype=compute_dtype)

    def apply_dw(node, h, q):
        if q and node.quantized:
            return depthwise_conv2d_w8a8(h, node.w_q, node.s_w, node.s_in, node.s_dq,
                                         out_dtype=compute_dtype, use_kernels=use_kernels)
        return conv2d(h, node.w, padding=1, groups=h.shape[-1], compute_dtype=compute_dtype)

    def report(site, h, y, apply):
        if tap is None:
            return
        if shadow is None:
            tap(site, y)
        else:  # the shadow node applies as stored: int8 where it is quantized
            tap(site, y, apply(_resolve_site(shadow, site), h, True))

    def reg(site, node, h, stride, padding):
        amax(site, h)
        y = apply_conv(node, h, stride, padding, quant)
        report(site, h, y, lambda n, hh, q: apply_conv(n, hh, stride, padding, q))
        return y

    def sep(site, s, h):
        amax(f"{site}/depthwise", h)
        y = apply_dw(s.depthwise, h, quant)
        report(f"{site}/depthwise", h, y, apply_dw)
        return reg(f"{site}/pointwise", s.pointwise, y, 1, 0)

    h = torch.relu(reg("conv1", tree.conv1, x, 2, 0))
    h = torch.relu(reg("conv2", tree.conv2, h, 1, 0))
    if upto == "stem":
        return h
    for k, blk in enumerate(tree.blocks):
        if fuse_middle and (blk.k1 or (quant and blk.k2)):
            if blk.k1:
                fn = middle_block if use_kernels else middle_block_ref
            else:
                fn = middle_block_w8 if use_kernels else middle_block_w8_ref
            h = fn(h.contiguous(), *blk.packed_operands())
        else:
            inp = h
            for i, unit in enumerate(blk.units):
                if i > 0 or blk.start_with_relu:
                    h = torch.relu(h)
                h = sep(f"blocks/{k}/units/{i}", unit, h)
            if blk.stride != 1:
                h = max_pool2d(h, 3, blk.stride, 1)
            skip = inp if blk.skip is None else reg(f"blocks/{k}/skip", blk.skip, inp, blk.stride, 0)
            h = h + skip
        if upto == f"block{k + 1}":
            return h
    h = torch.relu(sep("conv3", tree.conv3, h))
    h = torch.relu(sep("conv4", tree.conv4, h))
    if upto == "exit":
        return h
    out = global_avg_pool(h)
    if not features_only and tree.fc_w is not None:
        out = linear(out, tree.fc_w, tree.fc_b, compute_dtype=compute_dtype)
    return (out, obs) if observe else out


@torch.inference_mode()
def calibrate_amax(fp_tree: QuantizedXception, calib_x: torch.Tensor, *,
                   compute_dtype: torch.dtype = torch.bfloat16) -> Dict[str, np.ndarray]:
    """Per-site, per-input-channel amaxes of the plain fp walk over one
    calibration batch ``calib_x`` (serving-normalised, /255) at the compute
    dtype. Returns ``{site: fp32 (Ci,)}`` in walk order; both ``act_scales``
    modes of :func:`quantize_folded_xception` build from it."""
    _, obs = xception_quant_walk(fp_tree, calib_x, observe=True, compute_dtype=compute_dtype,
                                 features_only=True, use_kernels=False)
    return {k: v.cpu().numpy().astype(np.float32) for k, v in obs.items()}


def _quant_conv_node(node: ConvNode, a_vec, *, headroom: float, act_scales: str,
                     smooth_alpha: float, depthwise: bool = False) -> ConvNode:
    """Quantize one fp conv node against its calibrated input-amax vector.

    ``act_scales="tensor"``: ``s_in = amax/127``, dequant ``s_in * s_w``.
    ``act_scales="channel"``: SmoothQuant-style folding of a per-input-channel
    scale ``s_fold[c] = a_c^alpha / w_c^(1-alpha)`` into the weight before it
    is quantized, so every channel uses its whole int8 range; the quantize
    scale becomes ``s_fold * s_act`` and the epilogue keeps the scalar
    ``s_dq = s_act``. For a depthwise conv the fold lands on the output
    channel, where ``s_w`` absorbs it.
    """
    w = node.w.float()
    a_vec = np.atleast_1d(np.asarray(a_vec, np.float32))
    if act_scales == "tensor" or (act_scales == "channel" and a_vec.size == 1):
        w_q, s_w = quantize_weight(w)
        s_in = torch.tensor(max(float(a_vec.max()), 1e-12) * headroom / 127.0, dtype=torch.float32,
                            device=w.device)
        q = dict(w_q=w_q, s_w=s_w, s_in=s_in)
    elif act_scales == "channel":
        red = (1, 2, 3) if depthwise else (0, 2, 3)  # OIHW; depthwise folds on O
        w_c = torch.clamp_min(w.abs().amax(dim=red), 1e-8)
        a_c = torch.clamp_min(torch.tensor(a_vec, device=w.device), 1e-8)
        s_fold = a_c ** smooth_alpha / w_c ** (1.0 - smooth_alpha)
        shape = [1, 1, 1, 1]
        shape[0 if depthwise else 1] = -1
        w_q, s_w = quantize_weight(w * s_fold.reshape(shape))
        s_act = torch.clamp_min(torch.max(a_c / s_fold), 1e-12) * headroom / 127.0
        q = dict(w_q=w_q, s_w=s_w, s_in=(s_fold * s_act).float(), s_dq=s_act.float())
    else:
        raise ValueError(f"act_scales must be 'tensor' or 'channel', got {act_scales!r}")
    if node.b is not None:
        q["b"] = node.b.float()
    return ConvNode(**q)


@torch.inference_mode()
def quantize_folded_xception(
    fp_tree: QuantizedXception, amaxes: dict, *, headroom: float = 1.0,
    quant_depthwise: bool = False, skip_middle: bool = False, act_scales: str = "channel",
    smooth_alpha: float = 0.5,
) -> QuantizedXception:
    """The w8a8 tree from the fp32 fp tree and calibrated amaxes.

    ``headroom`` scales every activation amax. ``quant_depthwise`` also
    quantizes the depthwise 3x3s, so the activation chain through each
    sepconv unit stays int8. ``skip_middle`` leaves the middle-flow blocks
    fp, for K1 under ``fuse_middle``. ``act_scales``/``smooth_alpha``: see
    :func:`_quant_conv_node`; "channel" is the default, as in the JAX package.
    """
    missing = [s for s in _sites(fp_tree, depthwise=quant_depthwise) if s not in amaxes]
    if missing:
        raise ValueError(f"calibration amaxes missing sites: {missing}")

    def qconv(node, site, depthwise=False):
        return _quant_conv_node(node, amaxes[site], headroom=headroom, act_scales=act_scales,
                                smooth_alpha=smooth_alpha, depthwise=depthwise)

    def qsep(s, site):
        if quant_depthwise:
            dw = qconv(s.depthwise, f"{site}/depthwise", depthwise=True)
        else:
            dw = ConvNode(w=s.depthwise.w)
        return SepNode(dw, qconv(s.pointwise, f"{site}/pointwise"))

    blocks = []
    for k, (spec, blk) in enumerate(zip(XCEPTION_BLOCK_SPECS, fp_tree.blocks)):
        if skip_middle and spec[3] == 1 and spec[4]:
            blocks.append(blk)  # fp node, K1-routable
            continue
        units = [qsep(u, f"blocks/{k}/units/{i}") for i, u in enumerate(blk.units)]
        skip = None if blk.skip is None else qconv(blk.skip, f"blocks/{k}/skip")
        blocks.append(QuantBlock(spec, units, skip))
    return QuantizedXception(
        qconv(fp_tree.conv1, "conv1"), qconv(fp_tree.conv2, "conv2"), blocks,
        qsep(fp_tree.conv3, "conv3"), qsep(fp_tree.conv4, "conv4"), fp_tree.fc_w, fp_tree.fc_b)


def quantize_xception(model, calib_x: torch.Tensor, *, compute_dtype: torch.dtype = torch.bfloat16,
                      headroom: float = 1.0, quant_depthwise: bool = False) -> QuantizedXception:
    """fold (fp32) -> calibrate -> quantize in one call; ``model`` is a live-BN
    :class:`~.xception.Xception` on ``calib_x``'s device."""
    from .fold import fold_xception_bn

    fp_tree = QuantizedXception.from_folded(fold_xception_bn(model, torch.float32))
    amaxes = calibrate_amax(fp_tree, calib_x, compute_dtype=compute_dtype)
    return quantize_folded_xception(fp_tree, amaxes, headroom=headroom,
                                    quant_depthwise=quant_depthwise)


def quantized_xception_apply(tree: QuantizedXception, x: torch.Tensor, *,
                             compute_dtype: torch.dtype = torch.bfloat16,
                             features_only: bool = False, use_kernels: bool = True):
    """The w8a8 serving forward (the ``w8a8`` mode: no fused middle flow)."""
    return xception_quant_walk(tree, x, quant=True, compute_dtype=compute_dtype,
                               features_only=features_only, use_kernels=use_kernels)


def _fit_affine(mom, node: ConvNode, *, shrink: float = 1.0) -> ConvNode:
    """Per-channel least-squares fit ``f ~ gamma * q + beta`` -> the node with
    ``s_w * gamma`` and ``gamma * b + beta``.

    ``mom`` = ``(var_q, cov, qm, fm, qq, qf)``, fp32 per channel. A node
    without a bias (a depthwise) gets a gain through the origin only: the
    next pointwise's bias takes any shift. ``shrink`` in (0, 1] damps the
    correction toward identity (a thin calibration batch)."""
    var_q, cov, qm, fm, qq, qf = (m.float() for m in mom)
    fields = node.fields()
    if node.b is not None:
        ok = var_q > 1e-10
        gamma = torch.where(ok, cov / torch.where(ok, var_q, 1.0), 1.0)
        gamma = 1.0 + shrink * (gamma.clamp(0.5, 2.0) - 1.0)
        fields["b"] = gamma * node.b + shrink * (fm - gamma * qm)
    else:
        ok = qq > 1e-10
        gamma = torch.where(ok, qf / torch.where(ok, qq, 1.0), 1.0)
        gamma = 1.0 + shrink * (gamma.clamp(0.5, 2.0) - 1.0)
    fields["s_w"] = node.s_w * gamma
    return ConvNode(**fields)


def _moments(q: torch.Tensor, f: torch.Tensor):
    """Per-channel fp32 ``(var_q, cov, qm, fm, qq, qf)`` of a quantized conv
    output ``q`` and its teacher ``f`` over every position, and the number
    of positions. The centred moments are taken directly: ``E[q^2] - E[q]^2``
    cancels in fp32 on channels of large mean and small variance."""
    q, f = q.float(), f.float()
    ax = tuple(range(q.dim() - 1))
    qm, fm = q.mean(ax), f.mean(ax)
    var_q = ((q - qm) ** 2).mean(ax)
    cov = ((q - qm) * (f - fm)).mean(ax)
    return (var_q, cov, qm, fm, (q * q).mean(ax), (q * f).mean(ax)), q[..., 0].numel()


def _set_site(tree: nn.Module, site: str, node: ConvNode) -> None:
    parent, _, name = site.rpartition("/")
    setattr(_resolve_site(tree, parent) if parent else tree, name, node)


@torch.inference_mode()
def _refine_tree(qtree, fp_tree, calib_x: torch.Tensor, *, walk: Callable, sites: Sequence[str],
                 output_sites: Sequence[str], passes: int, shrink_n0: float,
                 compute_dtype: torch.dtype):
    """The backbone-agnostic core of the affine refinement (the scheme:
    :func:`refine_quantized_xception`). ``walk(tree, x, quant=,
    compute_dtype=, tap=, shadow=)`` must take the tap and shadow hooks;
    ``sites`` are the walk-order site keys. Returns a refined copy of
    ``qtree``."""
    qtree = copy.deepcopy(qtree)
    qsites = [s for s in sites if _resolve_site(qtree, s).quantized]
    qset = set(qsites)
    for _ in range(passes):
        mom = {}

        def local(site, y_f, y_q):
            if site in qset:
                mom[site] = _moments(y_q, y_f)[0]

        walk(fp_tree, calib_x, quant=False, compute_dtype=compute_dtype, tap=local, shadow=qtree)
        for site in qsites:  # all at once: each fit is its own site's error
            _set_site(qtree, site, _fit_affine(mom[site], _resolve_site(qtree, site)))
    for site in output_sites:  # sequential: re-measured after each correction
        if site not in qset:
            continue
        taps = {}
        walk(fp_tree, calib_x, quant=False, compute_dtype=compute_dtype,
             tap=lambda s, y: taps.__setitem__("f", y) if s == site else None)
        walk(qtree, calib_x, quant=True, compute_dtype=compute_dtype,
             tap=lambda s, y: taps.__setitem__("q", y) if s == site else None)
        mom, n = _moments(taps["q"], taps["f"])
        shrink = n / (n + shrink_n0)
        _set_site(qtree, site, _fit_affine(mom, _resolve_site(qtree, site), shrink=shrink))
    return qtree


def refine_quantized_xception(
    qtree: QuantizedXception, fp_tree: QuantizedXception, calib_x: torch.Tensor, *,
    passes: int = 1, output_sites: Sequence[str] = ("conv3/pointwise", "conv4/pointwise"),
    shrink_n0: float = 64.0, compute_dtype: torch.dtype = torch.float32,
) -> QuantizedXception:
    """Closed-form per-channel affine refinement of a w8a8 tree, folded into
    its dequant epilogue (``s_w *= gamma``, ``b = gamma * b + beta``), so the
    refined tree serves at the cost of the one it came from.

    1. **Local fits at every quantized site**, ``passes`` times: the walk's
       ``shadow`` applies each int8 node to the same fp input as its fp
       teacher in ``fp_tree``, so each fit sees only that conv's own
       quantization error, and all fits apply at once.
    2. **The output touch-up** at ``output_sites``, one after another, each
       re-measured on the refined tree's own forward: the exit pointwises
       take the error accumulated through the network, damped by
       ``N / (N + shrink_n0)`` for N positions per channel.

    ``qtree`` and ``fp_tree`` (``QuantizedXception.from_folded`` of the fp32
    fold) come from the same weights; ``calib_x`` is a serving-normalised
    NHWC batch. Every walk is the plain unfused one, on any device, and
    launches no kernel. Returns a new tree, its fused blocks packed anew."""
    walk = lambda tree, x, **kw: xception_quant_walk(tree, x, features_only=True,
                                                     use_kernels=False, **kw)
    refined = _refine_tree(qtree, fp_tree, calib_x, walk=walk,
                           sites=list(_sites(fp_tree, depthwise=True)), output_sites=output_sites,
                           passes=passes, shrink_n0=shrink_n0, compute_dtype=compute_dtype)
    refined.blocks = nn.ModuleList(  # K2's operands carry s_w and b: pack them again
        QuantBlock(spec, list(blk.units), blk.skip)
        for spec, blk in zip(XCEPTION_BLOCK_SPECS, refined.blocks))
    return refined


# ---------------------------------------------------------------------------
# ResNet-18 (the AU models' backbone, models/resnet.py): the same scheme
# ---------------------------------------------------------------------------

class ResBlockNode(nn.Module):
    """One BasicBlock of the tree: ``conv1``, ``conv2`` and ``downsample``
    (None without a projection) :class:`ConvNode` sites."""

    def __init__(self, stride: int, conv1: ConvNode, conv2: ConvNode,
                 downsample: Optional[ConvNode] = None):
        super().__init__()
        self.stride = stride
        self.conv1, self.conv2, self.downsample = conv1, conv2, downsample


class QuantizedResNet18(nn.Module):
    """The ResNet-18 tree of conv sites that :func:`resnet18_quant_walk`
    runs: all fp from :meth:`from_folded`, int8 from
    :func:`quantize_folded_resnet18`."""

    def __init__(self, conv1: ConvNode, stages: Sequence[Sequence[ResBlockNode]]):
        super().__init__()
        self.conv1 = conv1
        self.stages = nn.ModuleList(nn.ModuleList(stage) for stage in stages)

    @classmethod
    def from_folded(cls, folded: FoldedResNet18) -> "QuantizedResNet18":
        """The all-fp tree of a folded module (fp32, as the quantizer reads it)."""
        def node(blk, name):
            w = getattr(blk, f"{name}_w")
            return None if w is None else ConvNode(w=w, b=getattr(blk, f"{name}_b"))

        stages = [[ResBlockNode(blk.stride, node(blk, "conv1"), node(blk, "conv2"),
                                node(blk, "downsample")) for blk in stage]
                  for stage in folded.stages]
        return cls(ConvNode(w=folded.conv1_w, b=folded.conv1_b), stages)


def _resnet18_sites(tree: QuantizedResNet18) -> Iterator[str]:
    """Walk-order keys of every conv site: the stem, then each block's
    ``conv1``, ``conv2`` and ``downsample``."""
    yield "conv1"
    for i, stage in enumerate(tree.stages):
        for b, blk in enumerate(stage):
            yield f"stages/{i}/{b}/conv1"
            yield f"stages/{i}/{b}/conv2"
            if blk.downsample is not None:
                yield f"stages/{i}/{b}/downsample"


def resnet18_quant_walk(
    tree: QuantizedResNet18,
    x: torch.Tensor,
    *,
    quant: bool = False,
    observe: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
    tap: Optional[Callable] = None,
    shadow: Optional[QuantizedResNet18] = None,
):
    """The shared structural forward on NHWC images -> ``(N, 512)`` features:
    the fp folded forward (``quant=False``, equal to
    ``FoldedResNet18.forward``), with ``observe`` also each site's fp32
    ``(Ci,)`` input amax (returns ``(out, obs)``), or the w8a8 forward
    (``quant=True``). ``tap``/``shadow``: as in :func:`xception_quant_walk`."""
    if shadow is not None and tap is None:
        raise ValueError("shadow= needs a tap= to report the paired outputs to")
    obs = {} if observe else None

    def apply(node, h, stride, padding, q):
        if q and node.quantized:
            return conv2d_w8a8(h, node.w_q, node.s_w, node.s_in, node.b, node.s_dq,
                               stride=stride, padding=padding, out_dtype=compute_dtype)
        return conv2d(h, node.w, node.b, stride=stride, padding=padding,
                      compute_dtype=compute_dtype)

    def reg(site, node, h, stride, padding):
        if obs is not None:
            obs[site] = h.float().abs().amax(dim=(0, 1, 2))
        y = apply(node, h, stride, padding, quant)
        if tap is not None and shadow is None:
            tap(site, y)
        elif tap is not None:  # the shadow node applies as stored
            tap(site, y, apply(_resolve_site(shadow, site), h, stride, padding, True))
        return y

    h = max_pool2d(torch.relu(reg("conv1", tree.conv1, x, 2, 3)), 3, 2, 1)
    for i, stage in enumerate(tree.stages):
        for b, blk in enumerate(stage):
            r = torch.relu(reg(f"stages/{i}/{b}/conv1", blk.conv1, h, blk.stride, 1))
            r = reg(f"stages/{i}/{b}/conv2", blk.conv2, r, 1, 1)
            idn = h
            if blk.downsample is not None:
                idn = reg(f"stages/{i}/{b}/downsample", blk.downsample, h, blk.stride, 0)
            h = torch.relu(r + idn)
    out = global_avg_pool(h)
    return (out, obs) if observe else out


@torch.inference_mode()
def calibrate_resnet18_amax(fp_tree: QuantizedResNet18, calib_x: torch.Tensor, *,
                            compute_dtype: torch.dtype = torch.bfloat16) -> Dict[str, np.ndarray]:
    """Per-site, per-input-channel amaxes of the plain fp walk over
    ``calib_x`` (serving-normalised, /255) -> ``{site: fp32 (Ci,)}``."""
    _, obs = resnet18_quant_walk(fp_tree, calib_x, observe=True, compute_dtype=compute_dtype)
    return {k: v.cpu().numpy().astype(np.float32) for k, v in obs.items()}


@torch.inference_mode()
def quantize_folded_resnet18(
    fp_tree: QuantizedResNet18, amaxes: dict, *, headroom: float = 1.0,
    act_scales: str = "channel", smooth_alpha: float = 0.5,
) -> QuantizedResNet18:
    """The w8a8 tree from the fp32 fp tree and calibrated amaxes, every conv
    int8; ``headroom``, ``act_scales`` and ``smooth_alpha``: see
    :func:`_quant_conv_node`."""
    def qconv(node, site):
        if site not in amaxes:
            raise ValueError(f"calibration amaxes missing site: {site}")
        return _quant_conv_node(node, amaxes[site], headroom=headroom, act_scales=act_scales,
                                smooth_alpha=smooth_alpha)

    stages = [[ResBlockNode(
        blk.stride, qconv(blk.conv1, f"stages/{i}/{b}/conv1"),
        qconv(blk.conv2, f"stages/{i}/{b}/conv2"),
        None if blk.downsample is None else qconv(blk.downsample, f"stages/{i}/{b}/downsample"))
        for b, blk in enumerate(stage)] for i, stage in enumerate(fp_tree.stages)]
    return QuantizedResNet18(qconv(fp_tree.conv1, "conv1"), stages)


def refine_quantized_resnet18(
    qtree: QuantizedResNet18, fp_tree: QuantizedResNet18, calib_x: torch.Tensor, *,
    passes: int = 1, output_sites: Sequence[str] = ("stages/3/1/conv2",),
    shrink_n0: float = 64.0, compute_dtype: torch.dtype = torch.float32,
) -> QuantizedResNet18:
    """The affine refinement of :func:`refine_quantized_xception` on a w8a8
    ResNet-18 tree: local fits at every site, then the output touch-up at
    the last block's ``conv2``, the residual-branch conv nearest the pooled
    features. Returns a new tree."""
    return _refine_tree(qtree, fp_tree, calib_x, walk=resnet18_quant_walk,
                        sites=list(_resnet18_sites(fp_tree)), output_sites=output_sites,
                        passes=passes, shrink_n0=shrink_n0, compute_dtype=compute_dtype)
