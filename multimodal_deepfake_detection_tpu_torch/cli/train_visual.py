"""Train the video model (XceptionLSTMV + ArcFace) on face npy trees.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/train_visual.py``, with
the same ``Config`` fields and defaults: hidden 128, ArcFace s=30 / m=0.5,
cross-entropy on the margin logits, Adam 1e-5 with L2 weight decay 1e-4,
global-norm clip 1.0, plateau LR (factor 0.5, patience 3), the backbone
frozen for the first 3 epochs, early stop after 6 epochs without a joint
best (loss AND EER), batch 4, 50 frames a clip in buckets of 25 and 50. The
best ``{model, arcface, state}`` bundle is written in the JAX layout, so
both packages' ``VisualScorer.from_bundle`` (and the port's ``cli/serve.py
--engine visual``) serve it.

    python -m multimodal_deepfake_detection_tpu_torch.cli.train_visual \\
        --train_folder faces/train --eval_folder faces/eval --checkpoint_dir ckpt

It trains on ``--device cuda`` unless asked for ``cpu``, and raises if the
device is missing. ``--compute_dtype bfloat16`` (the default) casts
activations and weights to bf16 for the convolutions and matmuls (parameters,
BN statistics and the loss stay fp32, no loss scaling, as in JAX);
``float32`` runs in IEEE fp32 with TF32 off. The eval pass applies the
margin with the labels, a reference quirk (``--eval_with_margin false``
evaluates margin-free, as serving scores). ``--cache_features true``
(with ``--shuffle false``) serves the frozen epochs from a one-shot feature
cache of the eval-BN backbone; ``--remat true`` recomputes each block's
activations in the backward.

``--mode npy`` (the default) reads flat ``real_*`` / ``fake_*`` npy trees.
The metadata modes read the reference's datasets through
``data/video_enhanced.py``: ``fakeavceleb`` (``--csv_path`` meta_data.csv,
npy items), ``lavdf`` (``--lavdf_json`` metadata.json, npy items) and
``lavdf_raw`` (the same, video files decoded by the native engines or cv2,
resized to ``--frame_size``, optionally face-cropped with
``--use_face_detection``), the ``train`` subset from ``--train_folder`` and
``eval`` from ``--eval_folder``; ``--sample_percentage`` and
``--augment_minority`` draw the training samples as the JAX CLI does, and
``--num_workers`` loads a batch's clips on that many threads (in every
mode; the batches do not change).

``--jsonl_log`` writes one JSON object per epoch and ``--tracker`` adds
TensorBoard or wandb sinks (``utils/metric_logger.py``), as in JAX. Not
ported yet, and raising when asked for: the orbax backend (ROADMAP Queue 1
item 11). The train-state snapshot for ``--resume`` is a ``torch.save``
file, ``train_visual_state.pt``.
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.checkpoint import load_state, save_bundle, save_state
from ..core.config import parse_config
from ..core.precision import parse_dtype
from ..data.datasets import NpyFolderDataset
from ..data.loader import DataLoader
from ..models.heads import (
    XceptionLSTMArcFace,
    arcface_apply,
    xception_lstm_embed,
    xception_lstm_features,
)
from ..models.losses import cross_entropy_loss
from ..train import PlateauScheduler, TrainLoop, TrainState, make_optimizer
from ..train.feature_cache import PhaseSwitchLoader, _EpochCounter
from ..train.steps import make_eval_step, make_train_step
from ..utils.jax_weights import arcface_to_jax, xception_lstm_to_jax
from .common import epoch_logger, precision, raise_unported, resolve_device, to_device


@dataclasses.dataclass
class Config:
    """train_visual configuration (defaults = the JAX CLI's)."""

    train_folder: str = "Dataset/processed/train"
    eval_folder: str = "Dataset/processed/eval"
    checkpoint_dir: str = "Checkpoints"
    bundle_name: str = "XceptionLSTMV_ArcFace_Best.npz"
    hidden_dim: int = 128
    arcface_s: float = 30.0
    arcface_m: float = 0.5
    batch_size: int = 4
    lr: float = 1e-5
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    epochs: int = 50
    freeze_epochs: int = 3
    eval_every: int = 1
    early_stop_patience: int = 6
    plateau_factor: float = 0.5
    plateau_patience: int = 3
    max_frames: int = 50
    # 'npy' (flat filename-label tree) or the metadata modes 'fakeavceleb',
    # 'lavdf' and 'lavdf_raw' (decoded video)
    mode: str = "npy"
    csv_path: Optional[str] = None
    lavdf_json: Optional[str] = None
    use_face_detection: bool = False
    frame_size: Tuple[int, int] = (224, 224)
    augment_minority: bool = False
    sample_percentage: float = 1.0
    seed: int = 0
    shuffle: bool = True
    compute_dtype: str = "bfloat16"
    buckets: Tuple[int, ...] = (25, 50)
    mask_padding: bool = True
    # the per-epoch eval applies the margin with labels (reference quirk);
    # false evaluates margin-free, as the test CLI and serving score
    eval_with_margin: bool = True
    remat: bool = False  # recompute each backbone block's activations in the backward
    # the backbone's BN on its running statistics during the frozen epochs
    backbone_bn_eval: bool = False
    # the frozen epochs from a one-shot feature cache (needs shuffle=false and
    # freeze_epochs > 0; implies backbone_bn_eval while frozen)
    cache_features: bool = False
    jsonl_log: Optional[str] = None
    tracker: Optional[str] = None
    num_workers: int = 0
    ckpt_backend: str = "npz"
    resume: Optional[str] = None  # a train_visual_state.pt snapshot
    save_resume_state: bool = True
    device: str = "cuda"


# fields whose piece of the JAX package is not ported yet: (the item it waits for)
_NOT_PORTED = {"ckpt_backend": "the orbax backend (ROADMAP Queue 1 item 11)"}
MODES = ("npy", "fakeavceleb", "lavdf", "lavdf_raw")


def check_config(config: Config) -> None:
    """Raise on a flag whose piece is not ported, never ignore it."""
    if config.mode not in MODES:
        raise ValueError(f"--mode {config.mode}: one of {', '.join(MODES)}")
    raise_unported(config, _NOT_PORTED)
    if config.cache_features:
        if config.freeze_epochs <= 0:
            raise ValueError("--cache_features requires freeze_epochs > 0 (it caches "
                             "the frozen-phase backbone forward)")
        if config.shuffle:
            raise ValueError("--cache_features requires --shuffle false (the cached "
                             "phase replays the epoch-0 batch order)")


def save_visual_bundle(path: str, model: XceptionLSTMArcFace) -> None:
    """The JAX ``train_visual`` bundle ``{model, arcface, state}``."""
    params, state = xception_lstm_to_jax(model)
    save_bundle(path, {"model": params, "arcface": arcface_to_jax(model.arcface),
                       "state": state})


def make_forward(config: Config, cdtype: torch.dtype):
    """The CLI's loss forward: ``forward(model, batch, train, bb_eval=False)
    -> (loss, bn_stats, probs)`` on a device batch ``(video, labels,
    lengths)``; ``video`` is frames ``(B, T, H, W, 3)`` or cached features
    ``(B, T, 2048)``. ``bb_eval`` keeps the backbone's BN on its running
    statistics in a train step."""

    def forward(model, batch, train: bool, bb_eval: bool = False):
        video, labels, lengths = batch
        if video.ndim == 3:  # cached (B, T, F) frozen-phase features
            feats, bn_stats = video, []
        else:
            feats, bn_stats = xception_lstm_features(
                model, video, mode="video", train=train and not bb_eval, compute_dtype=cdtype,
                remat=config.remat and train)
        emb = xception_lstm_embed(model, feats, lengths=lengths,
                                  mask_padding=config.mask_padding, compute_dtype=cdtype)
        labels_i = labels.long()
        # margin with labels in train and (reference quirk) per-epoch eval passes
        margin_labels = labels_i if (train or config.eval_with_margin) else None
        logits = arcface_apply(model.arcface.w, emb, margin_labels, s=config.arcface_s,
                               m=config.arcface_m)
        loss = cross_entropy_loss(logits, labels_i, sample_weight=(lengths > 0).float())
        return loss, bn_stats, torch.softmax(logits, dim=-1)[:, 1]

    return forward


def make_loaders(config: Config, train_ds=None, eval_ds=None):
    """``(train_loader, eval_loader)`` of ``config.mode``; given datasets take
    the npy mode's loaders."""
    if config.mode != "npy" and train_ds is None:
        from ..data.video_enhanced import get_face_dataloader

        common = dict(
            mode=config.mode, csv_path=config.csv_path, lavdf_json=config.lavdf_json,
            batch_size=config.batch_size, use_face_detection=config.use_face_detection,
            frame_size=tuple(config.frame_size), max_frames=config.max_frames,
            buckets=config.buckets, seed=config.seed, num_workers=config.num_workers,
        )
        train_loader = get_face_dataloader(
            config.train_folder, subset="train", shuffle=config.shuffle,
            augment_minority=config.augment_minority,
            sample_percentage=config.sample_percentage, **common)
        return train_loader, get_face_dataloader(config.eval_folder, subset="eval", **common)
    train_ds = train_ds or NpyFolderDataset(config.train_folder, kind="video",
                                            max_frames=config.max_frames)
    eval_ds = eval_ds or NpyFolderDataset(config.eval_folder, kind="video",
                                          max_frames=config.max_frames)
    return (DataLoader(train_ds, config.batch_size, shuffle=config.shuffle, seed=config.seed,
                       buckets=config.buckets, item_workers=config.num_workers),
            DataLoader(eval_ds, config.batch_size, buckets=config.buckets,
                       item_workers=config.num_workers))


def build(config: Config, train_ds=None, eval_ds=None):
    """-> ``(train_loader, eval_loader, state, train_step, eval_step)``."""
    check_config(config)
    device = resolve_device(config.device)
    cdtype = parse_dtype(config.compute_dtype)

    train_loader, eval_loader = make_loaders(config, train_ds, eval_ds)

    model = XceptionLSTMArcFace(
        config.hidden_dim, generator=torch.Generator().manual_seed(config.seed)).to(device)
    opt = make_optimizer(model.parameters(), "adam", config.lr,
                         weight_decay=config.weight_decay, grad_clip=config.grad_clip)
    state = TrainState(0, model, opt)

    backbone_bn_eval = config.backbone_bn_eval or config.cache_features
    if config.cache_features:
        # the frozen backbone as it is now: the live one decays under L2 Adam
        feat_src = copy.deepcopy(model)

        @torch.no_grad()
        def feat_fn(x):
            with precision(cdtype):
                x = to_device((x,), device)[0]
                feats, _ = xception_lstm_features(feat_src, x, mode="video", compute_dtype=cdtype)
            return feats.float().cpu().numpy()

        ctr = _EpochCounter()
        train_loader = PhaseSwitchLoader(train_loader, feat_fn, switch_epoch=config.freeze_epochs,
                                         counter=ctr, role="train")
        eval_loader = PhaseSwitchLoader(eval_loader, feat_fn, switch_epoch=config.freeze_epochs,
                                        counter=ctr, role="eval")
        train_loader.feat_src = eval_loader.feat_src = feat_src

    _forward = make_forward(config, cdtype)

    def train_forward(bb_eval):
        def fwd(model, rng_seed, batch):
            loss, bn_stats, probs = _forward(model, batch, True, bb_eval)
            return loss, (bn_stats, probs)
        return fwd

    raw_train_step = make_train_step(train_forward(False))
    raw_train_step_bneval = make_train_step(train_forward(True)) if backbone_bn_eval else None

    def eval_forward(model, batch):
        loss, _, probs = _forward(model, batch, False)
        return loss, probs

    raw_eval_step = make_eval_step(eval_forward)

    def train_step(state, batch, rng_seed, epoch):
        frozen_now = epoch < config.freeze_epochs
        step = raw_train_step_bneval if (frozen_now and backbone_bn_eval) else raw_train_step
        with precision(cdtype):
            return step(state, to_device(batch, device), rng_seed,
                        ("backbone",) if frozen_now else ())

    def eval_step(state, batch):
        with precision(cdtype):
            return raw_eval_step(state, to_device(batch, device))

    return train_loader, eval_loader, state, train_step, eval_step


def main(argv=None, *, train_ds=None, eval_ds=None, log=print):
    config = parse_config(Config, argv, prog="train_visual")
    train_loader, eval_loader, state, train_step, eval_step = build(config, train_ds, eval_ds)

    os.makedirs(config.checkpoint_dir, exist_ok=True)
    best_path = os.path.join(config.checkpoint_dir, config.bundle_name)
    resume_path = os.path.join(config.checkpoint_dir, "train_visual_state.pt")

    if config.resume:
        load_state(config.resume, like=state)
        log(f"resumed train state from {config.resume} (step {state.step})")
        if config.cache_features:
            # cache features with the resumed (frozen) backbone, not the init one
            train_loader.feat_src.load_state_dict(state.model.state_dict())

    counts = np.bincount(np.asarray(train_loader.dataset.all_labels), minlength=2)
    log(f"class counts: real={counts[0]} fake={counts[1]}")

    def on_best(state, result):
        save_visual_bundle(best_path, state.model)
        log(f"new best model saved -> {best_path}")

    metric_logger = epoch_logger(config, "train_visual")

    def on_epoch(state, result):
        if config.save_resume_state:
            save_state(resume_path, state)
        if metric_logger is not None:
            metric_logger.log_epoch(result)

    loop = TrainLoop(
        train_step=train_step,
        eval_step=eval_step,
        state=state,
        train_loader=train_loader,
        eval_loader=eval_loader,
        num_epochs=config.epochs,
        eval_every=config.eval_every,
        early_stop_patience=config.early_stop_patience,
        plateau=PlateauScheduler(config.lr, factor=config.plateau_factor,
                                 patience=config.plateau_patience),
        best_policy="loss_and_eer",
        on_best=on_best,
        on_epoch=on_epoch,
        metrics_variant="basic",
        log=log,
        seed=config.seed,
    )
    history = loop.run()
    if metric_logger is not None:
        metric_logger.close()
    log("Training finished.")
    return history


if __name__ == "__main__":
    main()
