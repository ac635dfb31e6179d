"""Evaluate an AU-patch classifier bundle at three operating points.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/test_au_patch.py``,
with the same ``Config`` fields and defaults: the test split of the patch
loaders with augmentation off, the bundle's ``model`` merged strictly (its
``state`` leniently; without one, the initial BN statistics and a log
line), sigmoid scores, AUC/pAUC/EER, then accuracy and per-class counts at
three thresholds: 0.5, the EER-optimal ROC point and Youden's J.
``--save_embeddings`` writes the pooled pre-classifier embeddings (with the
labels and scores) for t-SNE; ``--saliency_dir`` writes input-gradient
saliency PNGs with the AU axis unrolled into the frame grid.

    python -m multimodal_deepfake_detection_tpu_torch.cli.test_au_patch \\
        --data_root patches --ckpt_path ckpt/best_au_patch_model.npz

It scores through the eval-BN ResNet-18 (cuDNN; no kernel of the port's
own, as the JAX CLI runs no Pallas kernel) on ``--device cuda`` unless
asked for ``cpu``, and raises if the device is missing;
``--compute_dtype float32`` runs IEEE fp32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.checkpoint import load_bundle, merge_params
from ..core.config import parse_config
from ..core.precision import parse_dtype
from ..data.au_patches import get_patch_image_loaders
from ..metrics import compute_eer_auc, pick_threshold, roc_curve
from ..models.resnet_lstm import AUPatchClassifier, au_patch_classifier_apply
from ..utils.jax_weights import au_patch_from_jax, au_patch_to_jax
from .common import precision, resolve_device, to_device


@dataclasses.dataclass
class Config:
    data_root: str = "Dataset/AU_Files/fakeavceleb_whole_image_patches"
    # metadata label/split sources
    mode: str = "fakeavceleb"
    csv_path: Optional[str] = None
    lavdf_json: Optional[str] = None
    include_unmatched_real: bool = False
    unmatched_split_seed: int = 42
    num_workers: int = 0
    ckpt_path: str = "Checkpoints/best_au_patch_model.npz"
    hidden_dim: int = 128
    lstm_hidden: int = 128
    batch_size: int = 2
    image_size: int = 128
    max_frames: int = 60
    max_aus: int = 17
    buckets: Tuple[int, ...] = ()
    compute_dtype: str = "bfloat16"
    mask_padding: bool = True
    seed: int = 0
    save_embeddings: Optional[str] = None  # npz of pooled embeddings + labels
    # input-gradient saliency PNGs for the first N batches (the AU axis
    # unrolled into the frame grid: each AU patch gets its own tile)
    saliency_dir: Optional[str] = None
    saliency_batches: int = 1
    device: str = "cuda"


def _counts_at(y, s, thr):
    preds = (s >= thr).astype(int)
    return {
        "acc": float((preds == y).mean()),
        "correct_real": int(((preds == 0) & (y == 0)).sum()),
        "total_real": int((y == 0).sum()),
        "correct_fake": int(((preds == 1) & (y == 1)).sum()),
        "total_fake": int((y == 1).sum()),
    }


class Scorer:
    """The eval model on its device. ``probs(patches, weights, lengths)``
    takes device tensors and is differentiable in the patches;
    ``score(batch)`` and ``embed(batch)`` (the pooled embeddings) take a
    host batch ``(patches, weights, labels, lengths)`` and return numpy."""

    def __init__(self, model: AUPatchClassifier, config: Config, device: torch.device):
        self.model, self.config, self.device = model, config, device
        self.cdtype = parse_dtype(config.compute_dtype)

    def _apply(self, patches, weights, lengths, **kw):
        return au_patch_classifier_apply(self.model, patches, weights, lengths=lengths,
                                         mask_padding=self.config.mask_padding,
                                         compute_dtype=self.cdtype, **kw)

    def probs(self, patches, weights, lengths) -> torch.Tensor:
        return torch.sigmoid(self._apply(patches, weights, lengths)[:, 0].float())

    @torch.no_grad()
    def _host(self, fn, batch) -> np.ndarray:
        patches, weights, _labels, lengths = batch
        with precision(self.cdtype):
            return fn(*to_device((patches, weights, lengths), self.device)).float().cpu().numpy()

    def score(self, batch) -> np.ndarray:
        return self._host(self.probs, batch)

    def embed(self, batch) -> np.ndarray:
        return self._host(lambda p, w, n: self._apply(p, w, n, return_pooled=True), batch)


def load_model(config: Config, *, log=print) -> Scorer:
    device = resolve_device(config.device)
    params, state = au_patch_to_jax(AUPatchClassifier(
        config.hidden_dim, config.lstm_hidden,
        generator=torch.Generator().manual_seed(config.seed)))
    bundle = load_bundle(config.ckpt_path)
    params = merge_params(params, bundle["model"], strict=True)
    if "state" in bundle:
        state = merge_params(state, bundle["state"], strict=False)
    else:
        log("[Load] bundle has no BN state; using initialization statistics")
    model = au_patch_from_jax(params, state).to(device).eval().requires_grad_(False)
    return Scorer(model, config, device)


def make_loader(config: Config):
    _train, test_l, _eval = get_patch_image_loaders(
        config.data_root,
        mode=config.mode,
        csv_path=config.csv_path,
        lavdf_json=config.lavdf_json,
        include_unmatched_real=config.include_unmatched_real,
        unmatched_split_seed=config.unmatched_split_seed,
        num_workers=config.num_workers,
        batch_size=config.batch_size,
        image_size=config.image_size,
        max_frames=config.max_frames,
        max_aus=config.max_aus,
        buckets=config.buckets or None,
        augment_train=False,
        augment_eval=False,
        augment_test=False,
        seed=config.seed,
    )
    return test_l


def evaluate(scorer: Scorer, loader, *, embeddings: bool = False):
    """-> ``(labels, scores, embeddings or None)`` of the rows with
    ``lengths > 0``."""
    all_s, all_y, all_emb = [], [], []
    for batch in loader:
        _patches, _weights, labels, lengths = batch
        mask = lengths > 0
        all_s.extend(scorer.score(batch)[mask].tolist())
        all_y.extend(labels[mask].astype(int).tolist())
        if embeddings:
            all_emb.extend(scorer.embed(batch)[mask].tolist())
    return np.asarray(all_y), np.asarray(all_s), np.asarray(all_emb) if embeddings else None


def main(argv=None, *, log=print):
    config = parse_config(Config, argv, prog="test_au_patch")
    test_l = make_loader(config)
    scorer = load_model(config, log=log)
    y, s, emb = evaluate(scorer, test_l, embeddings=bool(config.save_embeddings))
    auc, pauc, eer, _ = compute_eer_auc(y, s)
    log(f"AUC: {auc:.4f}  pAUC: {pauc:.4f}  EER: {eer:.4f}")

    # EER-optimal threshold: ROC point nearest the fpr=fnr crossing
    fpr, tpr, thr = roc_curve(y, s, drop_intermediate=False)
    eer_thr = float(thr[int(np.nanargmin(np.abs(fpr - (1 - tpr))))])
    youden_thr, _, _ = pick_threshold(y, s, mode="youden")

    results = {"AUC": auc, "pAUC": pauc, "EER": eer}
    for name, t in (("thr=0.5", 0.5), (f"thr=EER({eer_thr:.3f})", eer_thr),
                    (f"thr=Youden({youden_thr:.3f})", youden_thr)):
        c = _counts_at(y, s, t)
        results[name] = c
        log(
            f"[{name}] Acc={c['acc']:.4f} Real {c['correct_real']}/{c['total_real']} "
            f"Fake {c['correct_fake']}/{c['total_fake']}"
        )
    if config.save_embeddings:
        os.makedirs(os.path.dirname(os.path.abspath(config.save_embeddings)), exist_ok=True)
        np.savez(config.save_embeddings, embeddings=emb, labels=y, scores=s)
        log(f"saved embeddings -> {config.save_embeddings}")
    if config.saliency_dir:
        export_saliency(config, test_l, scorer, log=log)
    return results


def export_saliency(config: Config, loader, scorer: Scorer, *, log=print):
    """Input-gradient saliency PNGs for the first N batches."""
    from ..utils.saliency import input_saliency, save_saliency_grid

    for b, batch in enumerate(loader):
        if b >= config.saliency_batches:
            break
        patches, weights, labels, lengths = batch
        with precision(scorer.cdtype):
            sal = input_saliency(scorer.probs, *to_device((patches, weights, lengths),
                                                          scorer.device))
        sal = sal.cpu().numpy()
        # unroll the AU axis into the frame grid: (B,T,A,h,w[,3]) -> (B,T*A,h,w[,3])
        B, T, A = patches.shape[:3]
        save_saliency_grid(
            patches.reshape((B, T * A) + patches.shape[3:]),
            sal.reshape((B, T * A) + sal.shape[3:]),
            os.path.join(config.saliency_dir, f"saliency_batch{b}.png"),
            scores=scorer.score(batch), labels=labels, log=log,
        )


if __name__ == "__main__":
    main()
