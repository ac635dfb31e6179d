"""What the engine files share: building a scorer the way ``cli/serve.py``
builds it, and the reference run over clips in blocks."""
from __future__ import annotations

import numpy as np
import torch


def build_scorer(cfg: dict, bundle, device, overrides: dict):
    """The engine of ``cfg["serve"]`` through ``cli/serve.py::build_engine``
    (the CLI's own build), its checkpoint the in-memory ``bundle``;
    ``overrides`` replaces serve flags (a control's ``quantize``)."""
    from multimodal_deepfake_detection_tpu_torch.cli.serve import Config, build_engine

    flags = dict(cfg["serve"], device=str(device))
    flags.update(overrides or {})
    for key, value in flags.items():
        if isinstance(value, list):
            flags[key] = tuple(value)
    bundle.seek(0)
    return build_engine(Config(ckpt_path=bundle, **flags))


def seeded(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()
