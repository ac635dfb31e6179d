"""Path-keyed ``.npz`` bundles, numpy only.

The format is the JAX package's (``multimodal_deepfake_detection_tpu/core/
checkpoint.py``): one ``.npz`` holding named trees under slash-joined keys
(``model/backbone/conv1/w``), lists keyed by their decimal index. A bundle
written by either package loads in the other; this is how trained weights
reach the card. :func:`save_state` / :func:`load_state` snapshot the port's
train state for ``--resume`` (``torch.save``; torch is imported only there).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


def _flatten_with_paths(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_with_paths(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten_with_paths(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten_from_paths(flat: Dict[str, np.ndarray]):
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def save_bundle(path: str, trees: Dict[str, Any]) -> None:
    """Save named trees (e.g. ``{"model": params, "arcface": params}``) to .npz."""
    flat = {}
    for name, tree in trees.items():
        flat.update(_flatten_with_paths(tree, f"{name}/"))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_bundle(path: str) -> Dict[str, Any]:
    """Load a bundle back into nested dict/list trees of numpy arrays."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten_from_paths(flat)


def merge_params(init_params, loaded, *, strict: bool = True, _path="") -> Any:
    """Overlay ``loaded`` onto ``init_params`` structure by structure.

    Strict mode requires every key of ``init_params`` with the same shape;
    non-strict mode keeps init values for missing keys and ignores extra ones.
    """
    if isinstance(init_params, dict):
        out = {}
        for k, v in init_params.items():
            if isinstance(loaded, dict) and k in loaded:
                out[k] = merge_params(v, loaded[k], strict=strict, _path=f"{_path}{k}/")
            elif strict:
                raise KeyError(f"missing key in checkpoint: {_path}{k}")
            else:
                out[k] = v
        return out
    if isinstance(init_params, (list, tuple)):
        n = len(init_params)
        if not isinstance(loaded, (list, tuple)) or (strict and len(loaded) != n):
            if strict:
                raise ValueError(f"sequence mismatch at {_path}")
            loaded = list(loaded) if isinstance(loaded, (list, tuple)) else []
        out = [
            merge_params(v, loaded[i] if i < len(loaded) else v, strict=strict, _path=f"{_path}{i}/")
            for i, v in enumerate(init_params)
        ]
        return type(init_params)(out) if isinstance(init_params, tuple) else out
    if loaded is None:
        if strict:
            raise ValueError(f"missing leaf at {_path}")
        return init_params
    arr = np.asarray(loaded)
    if strict and arr.shape != np.shape(init_params):
        raise ValueError(f"shape mismatch at {_path}: {arr.shape} vs {np.shape(init_params)}")
    return arr


# ---------------------------------------------------------------------------
# Train-state snapshots (torch.save; the JAX package's are its own .npz)
# ---------------------------------------------------------------------------

def save_state(path: str, state) -> None:
    """Save a ``train.TrainState`` for ``--resume``: step, model parameters
    and BN buffers, optimizer (moments, accumulator, counts) and EMA."""
    import torch

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ema = None if state.ema is None else {"params": state.ema.params, "count": state.ema.count}
    torch.save({"step": state.step, "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(), "ema": ema}, path)


def load_state(path: str, like):
    """Load a :func:`save_state` snapshot into ``like`` (a TrainState of the
    same model and optimizer layout) in place, and return it."""
    import torch

    device = next(like.model.parameters()).device
    snap = torch.load(path, map_location=device, weights_only=True)
    like.step = snap["step"]
    like.model.load_state_dict(snap["model"])
    like.optimizer.load_state_dict(snap["optimizer"])
    if (snap["ema"] is None) != (like.ema is None):
        raise ValueError(f"{path}: EMA state {'missing' if snap['ema'] is None else 'unexpected'}")
    if like.ema is not None:
        like.ema.params, like.ema.count = snap["ema"]["params"], snap["ema"]["count"]
    return like
