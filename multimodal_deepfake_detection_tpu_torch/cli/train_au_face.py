"""Train the cross-modal face + AU detector with ArcFace and the
class-balanced focal loss.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/train_au_face.py``,
with the same ``Config`` fields and defaults:

* the joint face + AU loaders with the AU weights, the train split drawn by
  the class-balanced weighted sampler;
* the detector (17 AUs, tokens of 512, biLSTM 256) with both ResNet-18s in
  batch-statistics BN; the embed head, pooled concat (1024) -> 256 ->
  dropout (keep 0.8) -> 128; ArcFace (s 30, m 0.30);
* the class-balanced focal loss (beta 0.9999, gamma 2) from the train
  split's class counts, plus 0.2 x the pooled streams' alignment MSE and 0.1
  x the mean of their temporal smoothness (``--adaptive_loss`` learns the
  two weights);
* AdamW 1e-4 / wd 0.01 on a OneCycle schedule to 1e-3 (pct 0.3) over
  ``epochs x ceil(batches / accum_steps)`` optimizer steps, 4 micro-batches
  averaged a step, clip 1.0 per step; the equal-weight EMA of every
  parameter, folded in per optimizer step;
* eval with the EMA's detector and embed head and the current ArcFace head,
  margin-free probabilities, and the Youden and FPR <= 5 % operating points
  logged after each eval;
* the best-AUC bundle ``{model: EMA, embed: EMA, arcface: current, state,
  best_auc}`` in the JAX layout, which both packages' ``AUFaceScorer.
  from_bundle`` (and the port's ``cli/serve.py --engine au_face``) serve.
  They score with the detector's own ``head_fc1`` / ``head_fc2``, which this
  loss never reaches: a served score is not the eval probability (a
  reference quirk, kept).

    python -m multimodal_deepfake_detection_tpu_torch.cli.train_au_face \\
        --video_root faces --au_root patches --checkpoint_dir ckpt

It trains on ``--device cuda`` unless asked for ``cpu``, and raises if the
device is missing; ``--compute_dtype float32`` runs IEEE fp32 (TF32 off).
``--resume`` takes a ``train_au_face_state.pt`` snapshot; ``--ckpt_backend
orbax`` keeps versioned step directories under ``train_au_face_orbax``
(``core/orbax_ckpt.py``) and ``--resume auto`` restores the newest.
``--jsonl_log`` and ``--tracker`` log each epoch as in JAX
(``utils/metric_logger.py``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.config import parse_config
from ..core.precision import at_least_f32, parse_dtype
from ..data.au_patches import get_joint_dataloader
from ..data.loader import DataLoader
from ..metrics import compute_acc_ap_and_counts, pick_threshold
from ..models.au_face import AUFaceDetector, au_face_detector_apply
from ..models.heads import ArcFace, EmbedHead, arcface_apply, embed_head_apply
from ..models.losses import (
    adaptive_deepfake_loss,
    adaptive_loss_init,
    align_mse_loss,
    cb_focal_class_weights,
    cb_focal_loss,
    temporal_smoothness_loss,
)
from ..train import TrainLoop, TrainState, ema_init, make_optimizer, onecycle_schedule
from ..train.steps import SwappedParams, make_eval_step, make_train_step
from ..utils.jax_weights import save_au_face_bundle
from .common import (
    ResumeState,
    check_ckpt_backend,
    epoch_logger,
    precision,
    resolve_device,
    step_generator,
    to_device,
)


@dataclasses.dataclass
class Config:
    """train_au_face configuration (defaults = the JAX CLI's)."""

    video_root: str = "Dataset/FAVC_frames"
    au_root: str = "Dataset/AU_Files/fakeavceleb_whole_image_patches"
    checkpoint_dir: str = "Checkpoints"
    bundle_name: str = "auface_cross_best_auc_arcface_cb.npz"
    num_aus: int = 17
    face_dim: int = 512
    au_dim: int = 512
    lstm_hidden: int = 256
    embed_dim: int = 128
    arcface_s: float = 30.0
    arcface_m: float = 0.30
    cb_beta: float = 0.9999
    cb_gamma: float = 2.0
    lambda_align: float = 0.2
    lambda_temp: float = 0.1
    adaptive_loss: bool = False  # learn the align / temp weights as sigmoid(alpha), sigmoid(beta)
    batch_size: int = 2
    image_size: int = 128
    max_frames: int = 75
    # labels and splits from a FakeAVCeleb csv or a LAV-DF json; without
    # either, the flat {root}/{split} trees with filename labels
    csv_path: Optional[str] = None
    lavdf_mode: bool = False
    lavdf_json_path: Optional[str] = None
    num_workers: int = 0
    lr: float = 1e-4
    max_lr: float = 1e-3
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    accum_steps: int = 4
    epochs: int = 100
    early_stop_patience: int = 8
    weighted_sampler: bool = True
    seed: int = 42
    compute_dtype: str = "bfloat16"
    buckets: Tuple[int, ...] = ()
    fpr_target: float = 0.05
    jsonl_log: Optional[str] = None
    tracker: Optional[str] = None
    ckpt_backend: str = "npz"
    resume: Optional[str] = None  # a train_au_face_state.pt snapshot
    save_resume_state: bool = True
    device: str = "cuda"


def check_config(config: Config) -> None:
    """Raise on a flag value the CLI has no path for, never ignore it."""
    check_ckpt_backend(config)
    if config.face_dim != 2 * config.lstm_hidden or config.au_dim != 2 * config.lstm_hidden:
        raise ValueError("face_dim and au_dim are the biLSTM's output width, 2 * lstm_hidden")


class AUFaceTrainModel(nn.Module):
    """The trained tree, the JAX CLI's params ``{model, embed, arcface[,
    adaptive]}``: the detector, the embed head, ArcFace and, with
    ``adaptive``, the adaptive loss's two weights."""

    def __init__(self, config: Config, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.model = AUFaceDetector(config.lstm_hidden, generator=generator)
        self.embed = EmbedHead(config.face_dim + config.au_dim, out=config.embed_dim,
                               generator=generator)
        self.arcface = ArcFace(config.embed_dim, 2, generator=generator)
        if config.adaptive_loss:
            self.adaptive = nn.ParameterDict(adaptive_loss_init())


class LoopLoader:
    """``(videos, patches, labels, au_mask, au_weight, lengths)`` batches
    regrouped as the loop's ``((videos, patches, au_mask, au_weight),
    labels, lengths)``."""

    def __init__(self, loader):
        self.loader = loader
        self.dataset = loader.dataset

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for videos, patches, labels, au_mask, au_weight, lengths in self.loader:
            yield (videos, patches, au_mask, au_weight), labels, lengths


def pooled_embed(model: AUFaceTrainModel, batch, train: bool, cdtype,
                 generator: Optional[torch.Generator] = None):
    """The detector's full-axis forward, the token streams mean-pooled in at
    least fp32, and their embedding: ``(embed, v_pool, au_pool, v_tokens,
    au_tokens, bn_stats)``."""
    (videos, patches, au_mask, au_weight), _labels, _lengths = batch
    out = au_face_detector_apply(model.model, videos, patches, au_mask, au_weight,
                                 compute_dtype=cdtype, train=train)
    v_tokens, au_tokens = out[1], out[2]
    v_pool, au_pool = at_least_f32(v_tokens).mean(dim=1), at_least_f32(au_tokens).mean(dim=1)
    pooled = torch.cat([v_pool, au_pool], dim=-1).to(v_tokens.dtype)
    embed = embed_head_apply(model.embed, pooled, train=train, generator=generator,
                             compute_dtype=cdtype)
    return embed, v_pool, au_pool, v_tokens, au_tokens, (out[3] if train else [])


def make_forwards(config: Config, cdtype: torch.dtype, class_weights: torch.Tensor):
    """-> ``(train_forward(model, batch, generator) -> (loss, bn_stats,
    probs), eval_forward(model, batch) -> (loss, probs))``: the loss with
    the margin logits, the probabilities the softmax's fake column (margin
    logits in training, margin-free in eval, where the loss keeps the
    margin)."""
    s, m = config.arcface_s, config.arcface_m

    def cls_loss(model, embed, labels_i, lengths):
        logits = arcface_apply(model.arcface.w, embed, labels_i, s=s, m=m)
        return logits, cb_focal_loss(logits, labels_i, class_weights.to(logits.device),
                                     config.cb_gamma, sample_weight=(lengths > 0).float())

    def train_forward(model, batch, generator=None):
        embed, v_pool, au_pool, v_tokens, au_tokens, bn_stats = pooled_embed(
            model, batch, True, cdtype, generator)
        _, labels, lengths = batch
        logits, loss_cls = cls_loss(model, embed, labels.long(), lengths)
        loss_align = align_mse_loss(v_pool, au_pool)
        loss_temp = 0.5 * (temporal_smoothness_loss(v_tokens)
                           + temporal_smoothness_loss(au_tokens))
        if config.adaptive_loss:
            loss = adaptive_deepfake_loss(model.adaptive, loss_cls, loss_align, loss_temp)
        else:
            loss = loss_cls + config.lambda_align * loss_align + config.lambda_temp * loss_temp
        return loss, bn_stats, torch.softmax(logits, dim=-1)[:, 1]

    def eval_forward(model, batch):
        embed = pooled_embed(model, batch, False, cdtype)[0]
        _, labels, lengths = batch
        probs = torch.softmax(arcface_apply(model.arcface.w, embed, None, s=s), dim=-1)[:, 1]
        return cls_loss(model, embed, labels.long(), lengths)[1], probs

    return train_forward, eval_forward


def build(config: Config):
    """-> ``(train_loader, eval_loader, test_loader, state, train_step,
    eval_step)``."""
    check_config(config)
    device = resolve_device(config.device)
    cdtype = parse_dtype(config.compute_dtype)
    train_l, test_l, eval_l = get_joint_dataloader(
        config.video_root, config.au_root, csv_path=config.csv_path,
        lavdf_mode=config.lavdf_mode, lavdf_json_path=config.lavdf_json_path,
        num_workers=config.num_workers, batch_size=config.batch_size, shuffle=True,
        max_frames=config.max_frames, max_aus=config.num_aus, image_size=config.image_size,
        buckets=config.buckets or None, return_weights=True, seed=config.seed)
    if config.weighted_sampler:
        train_l = DataLoader(train_l.dataset, config.batch_size, weighted=True,
                             seed=config.seed, collate=train_l.collate)

    counts = np.bincount(np.asarray(train_l.dataset.all_labels), minlength=2)
    class_weights = cb_focal_class_weights([max(int(counts[0]), 1), max(int(counts[1]), 1)],
                                           beta=config.cb_beta)

    model = AUFaceTrainModel(config, torch.Generator().manual_seed(config.seed)).to(device)
    steps_per_epoch = max(1, int(np.ceil(len(train_l) / config.accum_steps)))
    opt = make_optimizer(model.parameters(), "adamw",
                         onecycle_schedule(config.max_lr, config.epochs * steps_per_epoch,
                                           pct_start=0.3),
                         weight_decay=config.weight_decay, grad_clip=config.grad_clip,
                         accum_steps=config.accum_steps)
    state = TrainState(0, model, opt, ema_init(model))
    train_forward, eval_forward = make_forwards(config, cdtype, class_weights)

    def loss_forward(model, rng_seed, batch):
        loss, bn_stats, probs = train_forward(model, batch, step_generator(device, rng_seed))
        return loss, (bn_stats, probs)

    raw_train_step = make_train_step(loss_forward, use_ema=True)
    raw_eval_step = make_eval_step(eval_forward, use_ema_params=True, keep_current=("arcface",))

    def train_step(state, batch, rng_seed, epoch):
        with precision(cdtype):
            return raw_train_step(state, to_device(batch, device), rng_seed)

    def eval_step(state, batch):
        with precision(cdtype):
            return raw_eval_step(state, to_device(batch, device))

    return (LoopLoader(train_l), LoopLoader(eval_l), LoopLoader(test_l), state, train_step,
            eval_step)


def save_best(path: str, state: TrainState, auc: float) -> None:
    """The bundle of the EMA's detector and embed head with the current
    ArcFace head and the live BN statistics."""
    model = state.model
    with SwappedParams(model, state.ema.params, keep=("arcface",)):
        save_au_face_bundle(path, model.model, model.embed, model.arcface, auc)


def main(argv=None, *, log=print):
    config = parse_config(Config, argv, prog="train_au_face")
    train_loader, eval_loader, _test_loader, state, train_step, eval_step = build(config)

    os.makedirs(config.checkpoint_dir, exist_ok=True)
    best_path = os.path.join(config.checkpoint_dir, config.bundle_name)
    snapshots = ResumeState(config, "train_au_face")
    snapshots.resume(state, config.resume, log)

    counts = np.bincount(np.asarray(train_loader.dataset.all_labels), minlength=2)
    log(f"[Info] Class counts (for CB-Focal): real={counts[0]}, fake={counts[1]}")

    def on_best(state, result):
        save_best(best_path, state, result.eval_metrics["AUC"])
        log(f"New best AUC: {result.eval_metrics['AUC']:.4f} - Model saved.")

    metric_logger = epoch_logger(config, "train_au_face")

    def on_epoch(state, result):
        if config.save_resume_state:
            snapshots.save(state, result.epoch)
        if metric_logger is not None:
            metric_logger.log_epoch(result)
        if result.eval_scores is None or not result.eval_scores[0].size:
            return
        y, s = result.eval_scores
        if len(np.unique(y)) < 2:
            return
        for name, mode in (("Youden", "youden"), (f"FPR<={config.fpr_target:.0%}", "fpr")):
            thr, fpr, tpr = pick_threshold(y, s, mode=mode, fpr_target=config.fpr_target)
            acc, ap, cr, tr, cf, tf = compute_acc_ap_and_counts(y, s, thr)
            log(f"Eval@{name}: Acc={acc:.4f}, AP={ap:.4f}, thr={thr:.3f}, FPR={fpr:.3f}, "
                f"TPR={tpr:.3f}, Correct[real]={cr}/{tr}, Correct[fake]={cf}/{tf}")

    loop = TrainLoop(
        train_step=train_step,
        eval_step=eval_step,
        state=state,
        train_loader=train_loader,
        eval_loader=eval_loader,
        num_epochs=config.epochs,
        early_stop_patience=config.early_stop_patience,
        best_policy="auc",
        on_best=on_best,
        on_epoch=on_epoch,
        metrics_variant="basic",
        log=log,
        seed=config.seed,
    )
    history = loop.run()
    if metric_logger is not None:
        metric_logger.close()
    log("Training Complete.")
    return history


if __name__ == "__main__":
    main()
