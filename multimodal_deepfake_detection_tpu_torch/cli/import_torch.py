"""Turn the reference's PyTorch checkpoints into ``.npz`` bundles.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/import_torch.py``,
with the same flags. Users of the reference bring ``.pth`` files in four
flavours; this CLI detects the flavour and writes the bundle that both
packages' ``load_bundle`` read (and the port's ``cli/serve.py`` serves):

* a plain Xception ``state_dict`` (e.g. the ImageNet weights of the frozen
  backbone) -> ``{model, state}``;
* an XceptionLSTMV/A ``state_dict`` -> ``{model, state}``;
* a ``{"model", "arcface"[, "embed"]}`` dict -> ``{model, arcface, state}``
  (``embed`` as well where present);
* DataParallel and EMA containers unwrapped (``module.`` stripped,
  ``n_averaged`` dropped).

    python -m multimodal_deepfake_detection_tpu_torch.cli.import_torch \\
        --src model.pth --dst model.npz

A host-side conversion: ``torch.load`` on the CPU, numpy out; nothing runs
on a device.
"""
from __future__ import annotations

import dataclasses

from ..core.config import parse_config


@dataclasses.dataclass
class Config:
    src: str = ""  # input .pth
    dst: str = ""  # output .npz bundle
    kind: str = "auto"  # 'auto' | 'xception' | 'xception_lstm'


def _detect(sd) -> str:
    keys = set(sd)
    if any(k.startswith("feature_extractor.") for k in keys):
        return "xception_lstm"
    if "conv1.weight" in keys and "block1.rep.0.conv1.weight" in keys:
        return "xception"
    raise ValueError(f"unrecognized checkpoint layout; first keys: {sorted(keys)[:8]}")


def convert(raw, kind: str, log=print) -> dict:
    """A loaded ``.pth`` (a ``state_dict``, a bundle dict or a module) -> the
    bundle's named trees."""
    from ..utils.torch_port import (
        arcface_params_from_torch,
        embed_head_params_from_torch,
        strip_prefixes,
        xception_lstm_params_from_torch,
        xception_params_from_torch,
    )

    def unwrap(sd):
        return strip_prefixes(sd, prefixes=("module.",))

    if isinstance(raw, dict) and "model" in raw and not any(
        hasattr(v, "shape") for v in raw.values() if not isinstance(v, dict)
    ):  # a bundle dict: {"model": sd, "arcface": sd, ...}
        model_sd = unwrap(raw["model"])
        kind = _detect(model_sd) if kind == "auto" else kind
        if kind == "xception_lstm":
            params, state = xception_lstm_params_from_torch(model_sd)
        else:
            params, state = xception_params_from_torch(model_sd)
        out = {"model": params, "state": state}
        if "arcface" in raw:
            out["arcface"] = arcface_params_from_torch(unwrap(raw["arcface"]))
        if "embed" in raw:
            out["embed"] = embed_head_params_from_torch(unwrap(raw["embed"]))
        log(f"converted bundle dict as {kind} (+{'arcface' if 'arcface' in raw else ''})")
        return out

    sd = unwrap(raw if isinstance(raw, dict) else raw.state_dict())
    kind = _detect(sd) if kind == "auto" else kind
    if kind == "xception_lstm":
        params, state = xception_lstm_params_from_torch(sd)
    elif kind == "xception":
        params, state = xception_params_from_torch(sd)
    else:
        raise ValueError(f"unknown kind {kind!r}")
    log(f"converted state_dict as {kind}")
    return {"model": params, "state": state}


def main(argv=None, *, log=print) -> dict:
    config = parse_config(Config, argv, prog="import_torch")
    if not config.src or not config.dst:
        raise SystemExit("--src input.pth and --dst output.npz are required")
    import torch

    from ..core.checkpoint import save_bundle

    raw = torch.load(config.src, map_location="cpu", weights_only=False)
    out = convert(raw, config.kind, log=log)
    save_bundle(config.dst, out)
    log(f"wrote {config.dst}")
    return out


if __name__ == "__main__":
    main()
