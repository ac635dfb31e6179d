"""Reference ``state_dict`` -> JAX-layout bundle trees (numpy only).

The port's copy of the JAX package's ``utils/torch_port.py``. Users bring
the reference's ``.pth`` checkpoints (the frozen backbone's Keras-ported
ImageNet weights, trained XceptionLSTMV/A models); this module turns a
torch ``state_dict`` (tensors or numpy arrays) into the param and state
trees of the ``.npz`` bundle that both packages' ``load_bundle`` read:

* conv OIHW -> HWIO; depthwise (C, 1, kh, kw) -> (kh, kw, 1, C); linear
  (out, in) -> (in, out); BN weight/bias/running_mean/running_var ->
  scale/bias/mean/var (the statistics at least fp32);
* LSTM ``weight_ih_l0`` / ``weight_hh_l0`` transposed to (in, 4H) / (H, 4H);
  the gate order (i, f, g, o) is shared, so nothing is reordered.

Arrays keep their numpy dtype (the JAX copy's ``jnp.asarray`` turns fp64
into fp32 unless x64 is on; the reference's checkpoints are fp32).
"""
from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np

from ..models.xception import XCEPTION_BLOCK_SPECS


def _np_f32up(x):
    a = _np(x)
    return a.astype(np.promote_types(a.dtype, np.float32))


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def conv_w(t):
    """OIHW -> HWIO."""
    return np.asarray(_np(t).transpose(2, 3, 1, 0))


def depthwise_w(t):
    """(C, 1, kh, kw) -> (kh, kw, 1, C) for feature_group_count=C."""
    return np.asarray(_np(t).transpose(2, 3, 1, 0))


def _bn(sd, prefix):
    params = {"scale": np.asarray(_np(sd[prefix + ".weight"])), "bias": np.asarray(_np(sd[prefix + ".bias"]))}
    state = {
        # at least fp32, not a hard cast: fp64 checkpoints keep fp64
        "mean": np.asarray(_np_f32up(sd[prefix + ".running_mean"])),
        "var": np.asarray(_np_f32up(sd[prefix + ".running_var"])),
    }
    return params, state


def _sep(sd, prefix):
    return {
        "depthwise": {"w": depthwise_w(sd[prefix + ".conv1.weight"])},
        "pointwise": {"w": conv_w(sd[prefix + ".pointwise.weight"])},
    }


def linear_params_from_torch(sd, prefix):
    p = {"w": np.asarray(_np(sd[prefix + ".weight"]).T)}
    if prefix + ".bias" in sd:
        p["b"] = np.asarray(_np(sd[prefix + ".bias"]))
    return p


def lstm_params_from_torch(sd, prefix, layer: int = 0):
    sfx = f"_l{layer}"
    return {
        "w_ih": np.asarray(_np(sd[f"{prefix}.weight_ih{sfx}"]).T),
        "w_hh": np.asarray(_np(sd[f"{prefix}.weight_hh{sfx}"]).T),
        "b_ih": np.asarray(_np(sd[f"{prefix}.bias_ih{sfx}"])),
        "b_hh": np.asarray(_np(sd[f"{prefix}.bias_hh{sfx}"])),
    }


def strip_prefixes(sd: Dict, prefixes=("module.", "feature_extractor.")) -> Dict:
    """Drop DataParallel/EMA wrappers the reference checkpoints accumulate
    (``module.`` strip + ``n_averaged`` drop, the reference's ``test_au_face.py``)."""
    out = {}
    for k, v in sd.items():
        if k.endswith("n_averaged"):
            continue
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def xception_lstm_params_from_torch(sd: Dict):
    """Convert an XceptionLSTMV/XceptionLSTMA state_dict to (params, bn_state).

    Layout per the reference's ``XceptionLSTMV.py``: ``feature_extractor.*``
    (Xception, fc replaced by Identity), ``lstm.*``, ``fc_layers.{0,3,6,9}.*``
    (Linear at every third Sequential slot), ``fc_out.*``.
    """
    backbone_sd = {k[len("feature_extractor."):]: v for k, v in sd.items() if k.startswith("feature_extractor.")}
    backbone, bn_state = xception_params_from_torch(backbone_sd, with_fc=False)
    params = {
        "backbone": backbone,
        "lstm": lstm_params_from_torch(sd, "lstm"),
        "fc_layers": [linear_params_from_torch(sd, f"fc_layers.{i}") for i in (0, 3, 6, 9)],
        "fc_out": linear_params_from_torch(sd, "fc_out"),
    }
    return params, {"backbone": bn_state}


def embed_head_params_from_torch(sd: Dict) -> Dict:
    """Convert the AU-face embed head Sequential (LazyLinear(256), ReLU,
    Dropout, Linear(256,128), the reference's ``train_au_face.py``;
    Linear params at Sequential slots 0 and 3) to {fc1, fc2}."""
    return {
        "fc1": linear_params_from_torch(sd, "0"),
        "fc2": linear_params_from_torch(sd, "3"),
    }


def arcface_params_from_torch(sd: Dict, prefix: str = "") -> Dict:
    """ArcFaceHead stores one (num_classes, feat_dim) 'weight' — same layout here."""
    key = (prefix + ".weight") if prefix else "weight"
    return {"w": np.asarray(_np(sd[key]))}


def xception_params_from_torch(sd: Dict, *, prefix: str = "", with_fc: Optional[bool] = None):
    """Convert a torch Xception state_dict into (params, state) pytrees.

    Block layout is discovered from key names (the torch ``rep`` Sequential
    indices shift with ``start_with_relu``), so the importer is robust to any
    of the reference's checkpoint flavors.
    """
    if prefix:
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    params: Dict = {}
    state: Dict = {}
    params["conv1"] = {"w": conv_w(sd["conv1.weight"])}
    params["bn1"], state["bn1"] = _bn(sd, "bn1")
    params["conv2"] = {"w": conv_w(sd["conv2.weight"])}
    params["bn2"], state["bn2"] = _bn(sd, "bn2")

    params["blocks"], state["blocks"] = [], []
    for b in range(1, len(XCEPTION_BLOCK_SPECS) + 1):
        base = f"block{b}"
        unit_idx = sorted(
            int(m.group(1))
            for k in sd
            if (m := re.fullmatch(rf"{base}\.rep\.(\d+)\.conv1\.weight", k))
        )
        bp, bs = {"units": []}, {"units": []}
        for i in unit_idx:
            bn_p, bn_s = _bn(sd, f"{base}.rep.{i + 1}")
            bp["units"].append({"sep": _sep(sd, f"{base}.rep.{i}"), "bn": bn_p})
            bs["units"].append({"bn": bn_s})
        if f"{base}.skip.weight" in sd:
            bn_p, bn_s = _bn(sd, f"{base}.skipbn")
            bp["skip"] = {"conv": {"w": conv_w(sd[f"{base}.skip.weight"])}, "bn": bn_p}
            bs["skip"] = {"bn": bn_s}
        params["blocks"].append(bp)
        state["blocks"].append(bs)

    params["conv3"] = _sep(sd, "conv3")
    params["bn3"], state["bn3"] = _bn(sd, "bn3")
    params["conv4"] = _sep(sd, "conv4")
    params["bn4"], state["bn4"] = _bn(sd, "bn4")

    if with_fc is None:
        with_fc = "fc.weight" in sd
    if with_fc:
        params["fc"] = linear_params_from_torch(sd, "fc")
    return params, state
