"""Evaluate a cross-modal face + AU bundle: metrics, score dump, t-SNE plots.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/test_au_face.py``,
with the same ``Config`` fields and defaults: flexible checkpoint loading
(a ``{model, ...}`` container or a bare tree, strict with a non-strict
fallback), the mean face and AU tokens and the sigmoid scores of the
detector's own logits head, the score sign flipped when AUC(1 - s) >
AUC(s), the other split when the asked one is empty, AUC/pAUC/EER with the
Youden and FPR <= ``fpr_target`` operating points, a
``scores_and_labels.npz`` dump, t-SNE plots of the face, AU and concatenated
streams (``--tsne``), and input-gradient saliency PNGs with respect to the
faces (``--saliency_dir``).

    python -m multimodal_deepfake_detection_tpu_torch.cli.test_au_face \\
        --video_root faces --au_root patches \\
        --ckpt_path ckpt/auface_cross_best_auc_arcface_cb.npz

It scores through the two eval-BN ResNet-18s (cuDNN; no kernel of the
port's own, as the JAX CLI runs no Pallas kernel) on ``--device cuda``
unless asked for ``cpu``, and raises if the device is missing;
``--compute_dtype float32`` runs IEEE fp32 (TF32 off). The non-strict
fallback fills the weights a bundle lacks from the port's seeded init
(``--seed``), not from the JAX package's ``PRNGKey`` init: a deliberate
deviation, so the two CLIs agree on complete bundles only; the ``[Load]``
lines are the same.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import parse_config
from ..core.precision import parse_dtype
from ..data.au_patches import get_joint_dataloader
from ..metrics import compute_acc_ap_and_counts, compute_eer_auc, pick_threshold
from ..models.au_face import AUFaceDetector, au_face_detector_apply
from ..models.serve import load_au_face_bundle
from ..utils.visualize import run_tsne_and_plot
from .common import precision, resolve_device, to_device


@dataclasses.dataclass
class Config:
    """test_au_face configuration (defaults = the JAX CLI's)."""

    video_root: str = "Dataset/FAVC_frames"
    au_root: str = "Dataset/AU_Files/fakeavceleb_whole_image_patches"
    ckpt_path: str = "Checkpoints/auface_cross_best_auc_arcface_cb.npz"
    output_dir: str = "eval_outputs"
    split: str = "eval"  # 'eval' | 'test' (with empty-split fallback)
    num_aus: int = 17
    face_dim: int = 512
    au_dim: int = 512
    lstm_hidden: int = 256
    batch_size: int = 2
    image_size: int = 128
    max_frames: int = 75
    # metadata label/split sources
    csv_path: Optional[str] = None
    lavdf_mode: bool = False
    lavdf_json_path: Optional[str] = None
    num_workers: int = 0
    buckets: Tuple[int, ...] = ()
    compute_dtype: str = "bfloat16"
    strict_load: bool = True  # falls back to non-strict on failure
    allow_sign_flip: bool = True
    fpr_target: float = 0.05
    tsne: bool = True
    tsne_max_samples: int = 2000
    # input-gradient saliency PNGs for the first N batches
    saliency_dir: Optional[str] = None
    saliency_batches: int = 1
    seed: int = 42
    device: str = "cuda"


class Scorer:
    """The eval detector on its device. ``run(videos, patches, au_mask,
    au_weight)`` of device tensors -> ``(probs, mean face token, mean AU
    token)``; ``probs`` is differentiable in the faces."""

    def __init__(self, model: AUFaceDetector, config: Config, device: torch.device):
        self.model, self.config, self.device = model, config, device
        self.cdtype = parse_dtype(config.compute_dtype)

    def run(self, videos, patches, au_mask, au_weight):
        logits, v_tokens, au_tokens = au_face_detector_apply(
            self.model, videos, patches, au_mask, au_weight, compute_dtype=self.cdtype)
        return (torch.sigmoid(logits[:, 0].float()), v_tokens.float().mean(1),
                au_tokens.float().mean(1))

    def probs(self, videos, patches, au_mask, au_weight) -> torch.Tensor:
        return self.run(videos, patches, au_mask, au_weight)[0]

    @torch.no_grad()
    def __call__(self, videos, patches, au_mask, au_weight):
        """Host arrays -> the three outputs of :meth:`run` as numpy."""
        with precision(self.cdtype):
            out = self.run(*to_device((videos, patches, au_mask, au_weight), self.device))
        return tuple(t.cpu().numpy() for t in out)


def load_detector_flexible(config: Config, log=print) -> Scorer:
    if config.face_dim != 2 * config.lstm_hidden or config.au_dim != 2 * config.lstm_hidden:
        raise ValueError("token dims are the biLSTM output width (2*lstm_hidden)")
    device = resolve_device(config.device)
    model = load_au_face_bundle(config.ckpt_path, config.lstm_hidden, strict=config.strict_load,
                                seed=config.seed, log=log)
    return Scorer(model.to(device).eval().requires_grad_(False), config, device)


def collect_features(loader, scorer: Scorer):
    """-> ``(feats_face, feats_au, labels, scores)`` of the rows with
    ``lengths > 0``."""
    all_face, all_au, all_lab, all_score = [], [], [], []
    for videos, patches, labels, au_mask, au_weight, lengths in loader:
        probs, face_mu, au_mu = scorer(videos, patches, au_mask, au_weight)
        mask = lengths > 0
        all_face.append(face_mu[mask])
        all_au.append(au_mu[mask])
        all_lab.append(labels[mask].astype(int))
        all_score.append(probs[mask])
    cat = lambda xs, d: np.concatenate(xs, 0) if xs else np.zeros((0, d))  # noqa: E731
    return (
        cat(all_face, 1),
        cat(all_au, 1),
        cat(all_lab, 1).reshape(-1) if all_lab else np.zeros((0,), int),
        cat(all_score, 1).reshape(-1) if all_score else np.zeros((0,)),
    )


def make_loader(config: Config, *, log=print):
    """The ``split`` loader, or the other split's when it is empty."""
    _train, test_l, eval_l = get_joint_dataloader(
        config.video_root,
        config.au_root,
        csv_path=config.csv_path,
        lavdf_mode=config.lavdf_mode,
        lavdf_json_path=config.lavdf_json_path,
        num_workers=config.num_workers,
        batch_size=config.batch_size,
        shuffle=False,
        max_frames=config.max_frames,
        max_aus=config.num_aus,
        image_size=config.image_size,
        buckets=config.buckets or None,
        return_weights=True,
        seed=config.seed,
    )
    loaders = {"eval": eval_l, "test": test_l}
    loader = loaders[config.split]
    if len(loader.dataset) == 0:
        other = "test" if config.split == "eval" else "eval"
        log(f"[Data] split '{config.split}' empty; falling back to '{other}'")
        loader = loaders[other]
    return loader


def sign_flip(labels, scores, *, log=print) -> bool:
    """Whether AUC(1 - s) beats AUC(s) (logged when it does)."""
    if labels.size == 0 or len(np.unique(labels)) < 2:
        return False
    auc_pos, *_ = compute_eer_auc(labels, scores)
    auc_neg, *_ = compute_eer_auc(labels, 1.0 - scores)
    if auc_neg > auc_pos:
        log(f"[Scores] sign auto-flip: AUC(1-s)={auc_neg:.4f} > AUC(s)={auc_pos:.4f}")
        return True
    return False


def main(argv=None, *, log=print):
    config = parse_config(Config, argv, prog="test_au_face")
    os.makedirs(config.output_dir, exist_ok=True)
    loader = make_loader(config, log=log)
    scorer = load_detector_flexible(config, log)
    feats_face, feats_au, labels, scores = collect_features(loader, scorer)

    if config.allow_sign_flip and sign_flip(labels, scores, log=log):
        scores = 1.0 - scores

    auc, pauc, eer, _ = compute_eer_auc(labels, scores)
    log(f"AUC: {auc:.4f}  pAUC@0.1: {pauc:.4f}  EER: {eer:.4f}")
    results = {"AUC": auc, "pAUC": pauc, "EER": eer}
    for mode, target in (("youden", None), ("fpr", config.fpr_target)):
        thr, fpr, tpr = pick_threshold(labels, scores, mode=mode, fpr_target=target or 0.01)
        acc, ap, cr, tr, cf, tf = compute_acc_ap_and_counts(labels, scores, thr)
        tag = "Youden" if mode == "youden" else f"FPR<={target:.0%}"
        results[tag] = {"acc": acc, "ap": ap, "thr": thr, "fpr": fpr, "tpr": tpr}
        log(
            f"[{tag}] Acc={acc:.4f} AP={ap:.4f} thr={thr:.3f} FPR={fpr:.3f} TPR={tpr:.3f} "
            f"Real {cr}/{tr} Fake {cf}/{tf}"
        )

    npz_path = os.path.join(config.output_dir, "scores_and_labels.npz")
    np.savez(npz_path, scores=scores, labels=labels)
    log(f"saved -> {npz_path}")

    if config.tsne and labels.size:
        for X, name in (
            (feats_face, "face_stream"),
            (feats_au, "au_stream"),
            (np.concatenate([feats_face, feats_au], axis=1), "concat_streams"),
        ):
            run_tsne_and_plot(
                X, labels, f"t-SNE {name}",
                os.path.join(config.output_dir, f"tsne_{name}.png"),
                seed=config.seed, max_samples=config.tsne_max_samples, log=log,
            )

    if config.saliency_dir:
        export_saliency(config, loader, scorer, log=log)
    return results


def export_saliency(config: Config, loader, scorer: Scorer, *, log=print):
    """Input-gradient saliency PNGs (w.r.t. the faces) for the first N batches."""
    from ..utils.saliency import input_saliency, save_saliency_grid

    for b, (videos, patches, labels, au_mask, au_weight, lengths) in enumerate(loader):
        if b >= config.saliency_batches:
            break
        with precision(scorer.cdtype):
            sal = input_saliency(scorer.probs, *to_device((videos, patches, au_mask, au_weight),
                                                          scorer.device))
        save_saliency_grid(
            videos, sal.cpu().numpy(),
            os.path.join(config.saliency_dir, f"saliency_batch{b}.png"),
            scores=scorer(videos, patches, au_mask, au_weight)[0], labels=labels, log=log,
        )


if __name__ == "__main__":
    main()
