"""Weight bridge: the JAX package's param/state trees <-> the port's modules.

The reverse of ``multimodal_deepfake_detection_tpu/utils/torch_port.py``. Trees
are nested dicts/lists of numpy arrays, as ``core/checkpoint.py`` bundles hold
them. Layouts:

* conv HWIO <-> OIHW; depthwise ``(3, 3, 1, C)`` <-> ``(C, 1, 3, 3)``;
* linear ``(in, out)`` <-> ``(out, in)``;
* LSTM ``w_ih (in, 4H)`` / ``w_hh (H, 4H)`` stay as they are, gate order
  ``(i, f, g, o)`` in both;
* ArcFace ``(classes, feat)`` and BN vectors stay as they are.

Each module is described once, as a walk over its leaves
``(tree, path, tensor, kind)``; export and import both follow that walk.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..core.checkpoint import save_bundle
from ..models.au_face import AUFaceDetector
from ..models.heads import ArcFace, EmbedHead, XceptionLSTM
from ..models.quant import (
    ConvNode,
    QuantBlock,
    QuantizedResNet18,
    QuantizedXception,
    ResBlockNode,
    SepNode,
)
from ..models.resnet import RESNET18_STAGES, ResNet18
from ..models.resnet_lstm import AUPatchClassifier
from ..models.xception import XCEPTION_BLOCK_SPECS, Xception

_TO_TORCH = {
    "conv": lambda a: a.transpose(3, 2, 0, 1),
    "linear": lambda a: a.T,
    "plain": lambda a: a,
}
_TO_JAX = {
    "conv": lambda a: a.transpose(2, 3, 1, 0),
    "linear": lambda a: a.T,
    "plain": lambda a: a,
}

Leaf = Tuple[str, tuple, torch.Tensor, str]  # (tree "params"|"state", path, tensor, kind)


def _bn_leaves(path, bn) -> Iterator[Leaf]:
    yield "params", path + ("scale",), bn.scale, "plain"
    yield "params", path + ("bias",), bn.bias, "plain"
    yield "state", path + ("mean",), bn.mean, "plain"
    yield "state", path + ("var",), bn.var, "plain"


def _sep_leaves(path, sep) -> Iterator[Leaf]:
    yield "params", path + ("depthwise", "w"), sep.depthwise, "conv"
    yield "params", path + ("pointwise", "w"), sep.pointwise, "conv"


def _linear_leaves(path, lin) -> Iterator[Leaf]:
    yield "params", path + ("w",), lin.w, "linear"
    yield "params", path + ("b",), lin.b, "plain"


def _xception_leaves(m: Xception, p: tuple = ()) -> Iterator[Leaf]:
    yield "params", p + ("conv1", "w"), m.conv1, "conv"
    yield from _bn_leaves(p + ("bn1",), m.bn1)
    yield "params", p + ("conv2", "w"), m.conv2, "conv"
    yield from _bn_leaves(p + ("bn2",), m.bn2)
    for k, blk in enumerate(m.blocks):
        for i, u in enumerate(blk.units):
            yield from _sep_leaves(p + ("blocks", k, "units", i, "sep"), u.sep)
            yield from _bn_leaves(p + ("blocks", k, "units", i, "bn"), u.bn)
        if blk.skip is not None:
            yield "params", p + ("blocks", k, "skip", "conv", "w"), blk.skip.conv, "conv"
            yield from _bn_leaves(p + ("blocks", k, "skip", "bn"), blk.skip.bn)
    yield from _sep_leaves(p + ("conv3",), m.conv3)
    yield from _bn_leaves(p + ("bn3",), m.bn3)
    yield from _sep_leaves(p + ("conv4",), m.conv4)
    yield from _bn_leaves(p + ("bn4",), m.bn4)
    if m.fc is not None:
        yield from _linear_leaves(p + ("fc",), m.fc)


def _lstm_leaves(path, lstm) -> Iterator[Leaf]:
    for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
        yield "params", path + (name,), getattr(lstm, name), "plain"


def _bilstm_leaves(path, bilstm) -> Iterator[Leaf]:
    yield from _lstm_leaves(path + ("fwd",), bilstm.fwd)
    yield from _lstm_leaves(path + ("bwd",), bilstm.bwd)


def _resnet18_leaves(m: ResNet18, p: tuple) -> Iterator[Leaf]:
    yield "params", p + ("conv1", "w"), m.conv1, "conv"
    yield from _bn_leaves(p + ("bn1",), m.bn1)
    for i, stage in enumerate(m.stages):
        for b, blk in enumerate(stage):
            q = p + ("stages", i, b)
            yield "params", q + ("conv1", "w"), blk.conv1, "conv"
            yield from _bn_leaves(q + ("bn1",), blk.bn1)
            yield "params", q + ("conv2", "w"), blk.conv2, "conv"
            yield from _bn_leaves(q + ("bn2",), blk.bn2)
            if blk.downsample is not None:
                yield "params", q + ("downsample", "conv", "w"), blk.downsample.conv, "conv"
                yield from _bn_leaves(q + ("downsample", "bn"), blk.downsample.bn)


def _au_patch_leaves(m: AUPatchClassifier) -> Iterator[Leaf]:
    yield from _resnet18_leaves(m.backbone, ("backbone",))
    yield from _linear_leaves(("au_fc",), m.au_fc)
    yield from _linear_leaves(("attn",), m.attn)
    yield from _bilstm_leaves(("lstm",), m.lstm)
    yield from _linear_leaves(("classifier",), m.classifier)


def _au_face_leaves(m: AUFaceDetector) -> Iterator[Leaf]:
    yield from _resnet18_leaves(m.face_backbone, ("face_backbone",))
    yield from _resnet18_leaves(m.au_backbone, ("au_backbone",))
    for name in ("face_proj", "au_proj", "au_attn"):
        yield from _linear_leaves((name,), getattr(m, name))
    yield from _bilstm_leaves(("face_lstm",), m.face_lstm)
    yield from _bilstm_leaves(("au_lstm",), m.au_lstm)
    for name in ("cross_q_face", "cross_q_au", "head_fc1", "head_fc2"):
        yield from _linear_leaves((name,), getattr(m, name))


def _xception_lstm_leaves(m: XceptionLSTM) -> Iterator[Leaf]:
    yield from _xception_leaves(m.backbone, ("backbone",))
    yield from _lstm_leaves(("lstm",), m.lstm)
    for i, lin in enumerate(m.fc_layers):
        yield from _linear_leaves(("fc_layers", i), lin)
    yield from _linear_leaves(("fc_out",), m.fc_out)


def _arcface_leaves(m: ArcFace) -> Iterator[Leaf]:
    yield "params", ("w",), m.w, "plain"


def _embed_head_leaves(m: EmbedHead) -> Iterator[Leaf]:
    yield from _linear_leaves(("fc1",), m.fc1)
    yield from _linear_leaves(("fc2",), m.fc2)


def _export(leaves) -> Tuple[Dict, Dict]:
    trees: Dict[str, Dict] = {"params": {}, "state": {}}
    for tree, path, t, kind in leaves:
        node = trees[tree]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(_TO_JAX[kind](t.detach().cpu().numpy()))

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            return [node[i] for i in range(len(node))]
        return node

    return listify(trees["params"]), listify(trees["state"])


def _import(leaves, params, state) -> None:
    trees = {"params": params, "state": state}
    with torch.no_grad():
        for tree, path, t, kind in leaves:
            node = trees[tree]
            for p in path:
                node = node[p]
            a = torch.from_numpy(np.array(_TO_TORCH[kind](np.asarray(node))))
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"shape mismatch at {tree}/{'/'.join(map(str, path))}: "
                                 f"{tuple(a.shape)} vs {tuple(t.shape)}")
            t.copy_(a)


def xception_from_jax(params, state) -> Xception:
    num_classes = np.shape(params["fc"]["w"])[1] if "fc" in params else None
    model = Xception(num_classes)
    _import(_xception_leaves(model), params, state)
    return model


def xception_lstm_to_jax(model: XceptionLSTM) -> Tuple[Dict, Dict]:
    """-> (params, state) with ``state = {"backbone": ...}``, as ``xception_lstm_init``."""
    return _export(_xception_lstm_leaves(model))


def xception_lstm_from_jax(params, state) -> XceptionLSTM:
    model = XceptionLSTM(np.shape(params["lstm"]["w_hh"])[0])
    _import(_xception_lstm_leaves(model), params, state)
    return model


def arcface_to_jax(model: ArcFace) -> Dict:
    return _export(_arcface_leaves(model))[0]


def arcface_from_jax(params) -> ArcFace:
    num_classes, feat_dim = np.shape(params["w"])
    model = ArcFace(feat_dim, num_classes)
    _import(_arcface_leaves(model), params, {})
    return model


def embed_head_to_jax(model: EmbedHead) -> Dict:
    return _export(_embed_head_leaves(model))[0]


def embed_head_from_jax(params) -> EmbedHead:
    in_dim, hidden = np.shape(params["fc1"]["w"])
    model = EmbedHead(in_dim, hidden=hidden, out=np.shape(params["fc2"]["w"])[1])
    _import(_embed_head_leaves(model), params, {})
    return model


def au_patch_to_jax(model: AUPatchClassifier) -> Tuple[Dict, Dict]:
    """-> (params, state) with ``state = {"backbone": ...}``, as
    ``au_patch_classifier_init``."""
    return _export(_au_patch_leaves(model))


def au_patch_from_jax(params, state) -> AUPatchClassifier:
    model = AUPatchClassifier(np.shape(params["au_fc"]["w"])[1],
                              np.shape(params["lstm"]["fwd"]["w_hh"])[0])
    _import(_au_patch_leaves(model), params, state)
    return model


def au_face_to_jax(model: AUFaceDetector) -> Tuple[Dict, Dict]:
    """-> (params, state) with ``state = {"face_backbone", "au_backbone"}``, as
    ``au_face_detector_init``."""
    return _export(_au_face_leaves(model))


def au_face_from_jax(params, state) -> AUFaceDetector:
    model = AUFaceDetector(np.shape(params["face_lstm"]["fwd"]["w_hh"])[0])
    _import(_au_face_leaves(model), params, state)
    return model


# ---------------------------------------------------------------------------
# The trainers' best bundles, in the JAX CLIs' layouts
# ---------------------------------------------------------------------------

def save_audio_bundle(path: str, model: XceptionLSTM) -> None:
    """The JAX ``train_audio`` bundle ``{model, state}``."""
    params, state = xception_lstm_to_jax(model)
    save_bundle(path, {"model": params, "state": state})


def save_au_patch_bundle(path: str, model: AUPatchClassifier) -> None:
    """The JAX ``train_au_patch`` bundle ``{model, state}``."""
    params, state = au_patch_to_jax(model)
    save_bundle(path, {"model": params, "state": state})


def save_au_face_bundle(path: str, detector: AUFaceDetector, embed: EmbedHead,
                        arcface: ArcFace, best_auc: float) -> None:
    """The JAX ``train_au_face`` bundle ``{model, embed, arcface, state,
    best_auc}``, of the modules as given (the CLI passes the EMA's detector
    and embed head with the current ArcFace head)."""
    params, state = au_face_to_jax(detector)
    save_bundle(path, {"model": params, "embed": embed_head_to_jax(embed),
                       "arcface": arcface_to_jax(arcface), "state": state,
                       "best_auc": np.asarray(best_auc, np.float32)})


# ---------------------------------------------------------------------------
# Folded and w8a8 trees (models/quant.py): nodes {w [, b]} or
# {w_q, s_w, s_in [, s_dq] [, b]}; w and w_q are conv weights (HWIO <-> OIHW,
# depthwise (3, 3, 1, C) <-> (C, 1, 3, 3)), the rest stay as they are.
# ---------------------------------------------------------------------------

def _node_from_jax(node) -> ConvNode:
    return ConvNode(**{
        k: torch.from_numpy(np.array(_TO_TORCH["conv" if k in ("w", "w_q") else "plain"](
            np.asarray(v))))
        for k, v in node.items()
    })


def _node_to_jax(node: ConvNode) -> Dict:
    return {  # order="C", not ascontiguousarray, which makes a scalar 1-d
        k: np.array(_TO_JAX["conv" if k in ("w", "w_q") else "plain"](t.detach().cpu().numpy()),
                    order="C")
        for k, t in node.fields().items()
    }


def quantized_xception_from_jax(qtree) -> QuantizedXception:
    """A JAX ``quantize_folded_xception`` tree (or a ``fold_xception_bn`` one,
    all fp) -> :class:`QuantizedXception`."""
    sep = lambda s: SepNode(_node_from_jax(s["depthwise"]), _node_from_jax(s["pointwise"]))
    blocks = [
        QuantBlock(spec, [sep(u) for u in bp["units"]],
                   _node_from_jax(bp["skip"]) if "skip" in bp else None)
        for spec, bp in zip(XCEPTION_BLOCK_SPECS, qtree["blocks"])
    ]
    fc = qtree.get("fc")
    fc_w, fc_b = ((torch.from_numpy(np.array(np.asarray(fc["w"]).T)),
                   torch.from_numpy(np.array(np.asarray(fc["b"])))) if fc else (None, None))
    return QuantizedXception(_node_from_jax(qtree["conv1"]), _node_from_jax(qtree["conv2"]),
                             blocks, sep(qtree["conv3"]), sep(qtree["conv4"]), fc_w, fc_b)


def quantized_xception_to_jax(tree: QuantizedXception) -> Dict:
    """:class:`QuantizedXception` -> the JAX tree layout, numpy leaves."""
    sep = lambda s: {"depthwise": _node_to_jax(s.depthwise), "pointwise": _node_to_jax(s.pointwise)}
    blocks = []
    for blk in tree.blocks:
        bp = {"units": [sep(u) for u in blk.units]}
        if blk.skip is not None:
            bp["skip"] = _node_to_jax(blk.skip)
        blocks.append(bp)
    out = {"conv1": _node_to_jax(tree.conv1), "conv2": _node_to_jax(tree.conv2),
           "blocks": blocks, "conv3": sep(tree.conv3), "conv4": sep(tree.conv4)}
    if tree.fc_w is not None:
        out["fc"] = {"w": np.ascontiguousarray(tree.fc_w.detach().cpu().numpy().T),
                     "b": tree.fc_b.detach().cpu().numpy()}
    return out


def quantized_resnet18_from_jax(qtree) -> QuantizedResNet18:
    """A JAX ``quantize_folded_resnet18`` tree (or a ``fold_resnet18_bn`` one,
    all fp) -> :class:`QuantizedResNet18`."""
    stages = [[ResBlockNode(stride if b == 0 else 1, _node_from_jax(bp["conv1"]),
                            _node_from_jax(bp["conv2"]),
                            _node_from_jax(bp["downsample"]) if "downsample" in bp else None)
               for b, bp in enumerate(stage)]
              for (_, stride), stage in zip(RESNET18_STAGES, qtree["stages"])]
    return QuantizedResNet18(_node_from_jax(qtree["conv1"]), stages)


def quantized_resnet18_to_jax(tree: QuantizedResNet18) -> Dict:
    """:class:`QuantizedResNet18` -> the JAX tree layout, numpy leaves."""
    def block(blk):
        out = {"conv1": _node_to_jax(blk.conv1), "conv2": _node_to_jax(blk.conv2)}
        if blk.downsample is not None:
            out["downsample"] = _node_to_jax(blk.downsample)
        return out

    return {"conv1": _node_to_jax(tree.conv1),
            "stages": [[block(blk) for blk in stage] for stage in tree.stages]}
