"""Evaluate an XceptionLSTMA bundle on an MFCC npy tree.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/test_audio.py``, with
the same ``Config`` fields and defaults: the bundle's ``model`` merged
strictly (its ``state`` leniently; without one, the initial BN statistics,
and a log line says so), sigmoid outputs of the MLP head, accuracy at 0.5
and then AUC, pAUC and EER over the accumulated scores.

    python -m multimodal_deepfake_detection_tpu_torch.cli.test_audio \\
        --test_folder mfcc/test --ckpt_path ckpt/best_model_audio.npz

It scores through the unfolded eval-BN Xception (cuDNN and cuBLAS; no
kernel of the port's own) on ``--device cuda`` unless asked for ``cpu``,
and raises if the device is missing; ``--compute_dtype float32`` runs IEEE
fp32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.checkpoint import load_bundle
from ..core.config import parse_config
from ..core.precision import parse_dtype
from ..data.datasets import NpyFolderDataset
from ..data.loader import DataLoader
from ..metrics import compute_eer_auc
from ..models.heads import xception_lstm_features, xception_lstm_head_apply
from ..models.serve import merge_xception_lstm
from .common import precision, resolve_device, to_device


@dataclasses.dataclass
class Config:
    test_folder: str = "Dataset/processed_audio/test"
    ckpt_path: str = "Checkpoints/best_model_audio.npz"
    hidden_dim: int = 512
    batch_size: int = 8
    buckets: Tuple[int, ...] = (120,)
    compute_dtype: str = "bfloat16"
    mask_padding: bool = True
    seed: int = 0
    device: str = "cuda"


class Scorer:
    """The eval model on its device: ``probs(mfcc, lengths)`` of device
    tensors ``(B, T, 3, 13)`` -> ``(B,)``; called on a host batch ``(mfcc,
    labels, lengths)``, the same as numpy without gradients."""

    def __init__(self, model, config: Config, device: torch.device):
        self.model, self.config, self.device = model, config, device
        self.cdtype = parse_dtype(config.compute_dtype)

    def probs(self, mfcc: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        feats, _ = xception_lstm_features(self.model, mfcc, mode="audio",
                                          compute_dtype=self.cdtype)
        return xception_lstm_head_apply(self.model, feats, lengths=lengths,
                                        mask_padding=self.config.mask_padding,
                                        compute_dtype=self.cdtype)[:, 0]

    @torch.no_grad()
    def __call__(self, batch) -> np.ndarray:
        mfcc, _labels, lengths = to_device(batch, self.device)
        with precision(self.cdtype):
            return self.probs(mfcc, lengths).float().cpu().numpy()


def build_scorer(config: Config, *, log=print) -> Scorer:
    device = resolve_device(config.device)
    bundle = load_bundle(config.ckpt_path)
    model = merge_xception_lstm(bundle, config.hidden_dim,
                                torch.Generator().manual_seed(config.seed))
    if "state" not in bundle:
        log("[Load] bundle has no BN state; using initialization statistics")
    return Scorer(model.to(device).eval().requires_grad_(False), config, device)


def make_loader(config: Config, test_ds=None) -> DataLoader:
    test_ds = test_ds or NpyFolderDataset(config.test_folder, kind="audio")
    return DataLoader(test_ds, config.batch_size, buckets=config.buckets)


def evaluate(score_fn, loader):
    """-> ``(labels, scores)`` of the rows with ``lengths > 0``."""
    all_probs, all_labels = [], []
    for batch, labels, lengths in loader:
        probs = score_fn((batch, labels, lengths))
        mask = lengths > 0
        all_probs.extend(probs.ravel()[mask].tolist())
        all_labels.extend(labels[mask].astype(int).tolist())
    return np.asarray(all_labels), np.asarray(all_probs)


def main(argv=None, *, test_ds=None, log=print):
    config = parse_config(Config, argv, prog="test_audio")
    loader = make_loader(config, test_ds)
    score_fn = build_scorer(config, log=log)
    y, s = evaluate(score_fn, loader)
    acc = float(((s > 0.5).astype(int) == y).mean()) if y.size else 0.0
    auc, pauc, eer, _ = compute_eer_auc(y, s)
    log(f"Accuracy: {acc:.4f}\nAUC: {auc:.4f}\npAUC: {pauc:.4f}\nEER: {eer:.4f}")
    return {"Accuracy": acc, "AUC": auc, "pAUC": pauc, "EER": eer}


if __name__ == "__main__":
    main()
