"""Evaluate an XceptionLSTMV + ArcFace bundle on a face npy tree.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/test_visual.py``, with
the same ``Config`` fields and defaults: loads the ``{model, arcface[,
state]}`` bundle, scores with label-free ArcFace logits -> softmax[:, 1],
and reports the interpolated metric variant (normalized pAUC@0.1 with 0 =
random, interpolated-crossing EER, ACC@Youden) plus overall accuracy at 0.5
and per-class correct counts; ``--save_scores`` dumps
``scores_and_labels.npz``-style arrays, ``--saliency_dir`` writes
input-gradient saliency PNGs of the first ``--saliency_batches`` batches.

    python -m multimodal_deepfake_detection_tpu_torch.cli.test_visual \\
        --test_folder faces/test --ckpt_path ckpt/XceptionLSTMV_ArcFace_Best.npz

It scores through the unfolded eval-BN Xception (cuDNN and cuBLAS; no
kernel of the port's own, as the JAX CLI runs no Pallas kernel) on
``--device cuda`` unless asked for ``cpu``, and raises if the device is
missing. ``--compute_dtype bfloat16`` (the default) casts activations and
weights for the convolutions and matmuls; ``float32`` runs in IEEE fp32
with TF32 off. It scores on its one device: the JAX CLI's data mesh over
several devices waits for ROADMAP Queue 1 item 11 (sharding moves no
score). With ``--strict_load false`` a weight the bundle lacks keeps the
port's seeded init (``--seed``), not the JAX package's ``PRNGKey`` init: a
deliberate deviation (ROADMAP Queue 3, F4), so the two CLIs agree on
complete bundles. Not ported yet, and raising when asked for: ``--mode`` other
than ``npy`` and its flags (the video dataset modes, item 10b).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import parse_config
from ..core.precision import parse_dtype
from ..data.datasets import NpyFolderDataset
from ..data.loader import DataLoader
from ..metrics import compute_metrics_interp
from ..models.heads import ArcFace, arcface_apply, xception_lstm_embed, xception_lstm_features
from ..models.serve import load_visual_bundle
from .common import precision, raise_unported, resolve_device, to_device


@dataclasses.dataclass
class Config:
    """test_visual configuration (defaults = the JAX CLI's)."""

    test_folder: str = "Dataset/processed/test"
    ckpt_path: str = "Checkpoints/XceptionLSTMV_ArcFace_Best.npz"
    mode: str = "npy"  # the only mode ported; the video modes need decode
    subset: str = "test"
    csv_path: Optional[str] = None
    lavdf_json: Optional[str] = None
    frame_size: Tuple[int, int] = (224, 224)
    hidden_dim: int = 128
    arcface_s: float = 30.0
    batch_size: int = 4
    max_frames: int = 75
    buckets: Tuple[int, ...] = (25, 50, 75)
    compute_dtype: str = "bfloat16"
    mask_padding: bool = True
    strict_load: bool = True
    save_scores: Optional[str] = None  # path for the scores/labels npz
    # input-gradient saliency PNGs for the first N batches
    saliency_dir: Optional[str] = None
    saliency_batches: int = 1
    seed: int = 0
    device: str = "cuda"


_VIDEO_MODES = "the video dataset modes (ROADMAP Queue 1 item 10b)"
# fields whose piece of the JAX package is not ported yet: (the item it waits for)
_NOT_PORTED = {name: _VIDEO_MODES
               for name in ("mode", "subset", "csv_path", "lavdf_json", "frame_size")}


class Scorer:
    """The eval model on its device. ``probs(video, lengths)`` is the fake
    probability ``(B,)`` of device tensors (differentiable in ``video``);
    calling the scorer on a host batch ``(video, labels, lengths)`` returns
    it as numpy, without gradients."""

    def __init__(self, model, arcface: ArcFace, config: Config, device: torch.device):
        self.model, self.arcface, self.config, self.device = model, arcface, config, device
        self.cdtype = parse_dtype(config.compute_dtype)

    def probs(self, video: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        feats, _ = xception_lstm_features(self.model, video, mode="video",
                                          compute_dtype=self.cdtype)
        emb = xception_lstm_embed(self.model, feats, lengths=lengths,
                                  mask_padding=cfg.mask_padding, compute_dtype=self.cdtype)
        logits = arcface_apply(self.arcface.w, emb, None, s=cfg.arcface_s)
        return torch.softmax(logits, dim=-1)[:, 1]

    @torch.no_grad()
    def __call__(self, batch) -> np.ndarray:
        video, _labels, lengths = to_device(batch, self.device)
        with precision(self.cdtype):
            return self.probs(video, lengths).float().cpu().numpy()


def build_scorer(config: Config) -> Scorer:
    """The bundle merged onto a seeded initial tree (``strict_load``), its
    optional ``state`` non-strictly, on ``config.device``."""
    device = resolve_device(config.device)
    model, arc = load_visual_bundle(config.ckpt_path, config.hidden_dim,
                                    strict=config.strict_load, seed=config.seed)
    return Scorer(model.to(device).eval().requires_grad_(False),
                  arc.to(device).requires_grad_(False), config, device)


def export_saliency(config: Config, loader, score_fn: Scorer, *, log=print):
    """Input-gradient saliency PNGs for the first N batches (the same export
    as ``cli/test_au_face.py``'s ``--saliency_dir``)."""
    from ..utils.saliency import input_saliency, save_saliency_grid

    for b, (video, labels, lengths) in enumerate(loader):
        if b >= config.saliency_batches:
            break
        video_t, lengths_t = to_device((video, lengths), score_fn.device)
        with precision(score_fn.cdtype):
            sal = input_saliency(score_fn.probs, video_t, lengths_t)
        save_saliency_grid(
            video, sal.cpu().numpy(),
            os.path.join(config.saliency_dir, f"saliency_batch{b}.png"),
            scores=score_fn((video, labels, lengths)), labels=labels, log=log,
        )


def evaluate(score_fn, loader):
    all_probs, all_labels = [], []
    for batch, labels, lengths in loader:
        probs = np.asarray(score_fn((batch, labels, lengths)))
        mask = lengths > 0
        all_probs.extend(probs.ravel()[mask].tolist())
        all_labels.extend(labels[mask].astype(int).tolist())
    y = np.asarray(all_labels)
    s = np.asarray(all_probs)
    preds = (s > 0.5).astype(int)
    results = {
        "Accuracy": float((preds == y).mean()) if y.size else 0.0,
        **compute_metrics_interp(y, s),
        "correct_real": int(((preds == 0) & (y == 0)).sum()),
        "total_real": int((y == 0).sum()),
        "correct_fake": int(((preds == 1) & (y == 1)).sum()),
        "total_fake": int((y == 1).sum()),
    }
    return results, y, s


def make_loader(config: Config, test_ds=None) -> DataLoader:
    raise_unported(config, _NOT_PORTED)
    test_ds = test_ds or NpyFolderDataset(config.test_folder, kind="video",
                                          max_frames=config.max_frames)
    return DataLoader(test_ds, config.batch_size, buckets=config.buckets)


def main(argv=None, *, test_ds=None, log=print):
    config = parse_config(Config, argv, prog="test_visual")
    loader = make_loader(config, test_ds)
    score_fn = build_scorer(config)
    results, y, s = evaluate(score_fn, loader)

    log("\n=== Test Results ===")
    for k in ("Accuracy", "AUC", "AP", "pAUC", "EER", "ACC@J", "THR@J"):
        if k in results:
            log(f"{k}: {results[k]:.4f}")
    log(
        f"Classwise: Real {results['correct_real']}/{results['total_real']}, "
        f"Fake {results['correct_fake']}/{results['total_fake']}"
    )
    if config.save_scores:
        os.makedirs(os.path.dirname(os.path.abspath(config.save_scores)), exist_ok=True)
        np.savez(config.save_scores, scores=s, labels=y)
        log(f"saved scores -> {config.save_scores}")
    if config.saliency_dir:
        export_saliency(config, loader, score_fn, log=log)
    return results


if __name__ == "__main__":
    main()
