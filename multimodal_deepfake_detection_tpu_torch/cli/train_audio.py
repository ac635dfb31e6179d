"""Train the audio model (XceptionLSTMA) on MFCC npy trees.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/train_audio.py``,
with the same ``Config`` fields and defaults: hidden 512, BCE on the sigmoid
outputs weighted by ``lengths > 0``, Adam 1e-4, plateau LR (factor 0.5,
patience 5), eval every 10 epochs, early stop after 10 evals without a best
eval loss, batch 8, clips in one bucket of 120 MFCC frames. The backbone is
frozen (zero gradients), but its BN runs on batch statistics and updates its
running statistics, as the reference does (``--backbone_bn_eval true`` puts
it on its running statistics). The MLP head's dropout (keep 0.7) draws from a
generator seeded by the step. The best ``{model, state}`` bundle is written
in the JAX layout, so both packages' ``AudioScorer.from_bundle`` (and the
port's ``cli/serve.py --engine audio``) serve it.

    python -m multimodal_deepfake_detection_tpu_torch.cli.train_audio \\
        --train_folder mfcc/train --eval_folder mfcc/eval --checkpoint_dir ckpt

It trains on ``--device cuda`` unless asked for ``cpu``, and raises if the
device is missing; ``--compute_dtype float32`` runs IEEE fp32 (TF32 off).
``--cache_features true`` computes the frozen eval-BN backbone's features
once and trains the head on them (it needs the frozen backbone and implies
``--backbone_bn_eval``); ``--remat true`` recomputes each backbone block in
the backward. ``--resume`` takes a ``train_audio_state.pt`` snapshot.

``--native_loader true`` assembles the batches in the C++ npy collate
(``data/native_loader.py``, built from ``native/npy_collate.cc``), bit-equal
to the Python loader's. ``--jsonl_log`` and ``--tracker`` log each epoch as
in JAX (``utils/metric_logger.py``). Not ported yet, and raising when asked
for: the orbax backend (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Optional, Tuple

import torch

from ..core.checkpoint import load_state, save_state
from ..core.config import parse_config
from ..core.precision import parse_dtype
from ..data.datasets import NpyFolderDataset
from ..data.loader import DataLoader
from ..models.heads import XceptionLSTM, xception_lstm_features, xception_lstm_head_apply
from ..models.losses import bce_loss
from ..train import PlateauScheduler, TrainLoop, TrainState, make_optimizer
from ..train.feature_cache import FeatureCachingLoader
from ..train.steps import make_eval_step, make_train_step
from ..utils.jax_weights import save_audio_bundle
from .common import (
    epoch_logger,
    precision,
    raise_unported,
    resolve_device,
    step_generator,
    to_device,
)


@dataclasses.dataclass
class Config:
    """train_audio configuration (defaults = the JAX CLI's)."""

    train_folder: str = "Dataset/processed_audio/train"
    eval_folder: str = "Dataset/processed_audio/eval"
    checkpoint_dir: str = "Checkpoints"
    hidden_dim: int = 512
    batch_size: int = 8
    lr: float = 1e-4
    epochs: int = 100
    eval_every: int = 10
    early_stop_patience: int = 10
    plateau_factor: float = 0.5
    plateau_patience: int = 5
    seed: int = 0
    compute_dtype: str = "bfloat16"
    buckets: Tuple[int, ...] = (120,)
    mask_padding: bool = True  # false: the reference's pad-consuming last step
    remat: bool = False  # recompute each backbone block's activations in the backward
    freeze_backbone: bool = True
    backbone_bn_eval: bool = False  # the frozen backbone's BN on its running statistics
    # the frozen eval-BN backbone's features computed once, the head trained
    # on them (needs freeze_backbone; implies backbone_bn_eval)
    cache_features: bool = False
    native_loader: bool = False  # the C++ npy collate (native/npy_collate.cc)
    jsonl_log: Optional[str] = None
    tracker: Optional[str] = None
    ckpt_backend: str = "npz"
    resume: Optional[str] = None  # a train_audio_state.pt snapshot
    save_resume_state: bool = True
    device: str = "cuda"


_NOT_PORTED = {"ckpt_backend": "the orbax backend (ROADMAP Queue 1 item 11)"}
BUNDLE_NAME = "best_model_audio.npz"


def check_config(config: Config) -> None:
    """Raise on a flag whose piece is not ported, never ignore it."""
    raise_unported(config, _NOT_PORTED)
    if config.cache_features and not config.freeze_backbone:
        raise ValueError("--cache_features requires --freeze_backbone (the cached "
                         "features are only invariant for a frozen backbone)")


def make_forward(config: Config, cdtype: torch.dtype, bb_eval: bool):
    """The CLI's loss forward: ``forward(model, batch, train, generator=None)
    -> (loss, bn_stats, probs)`` on a device batch ``(x, labels, lengths)``;
    ``x`` is MFCC steps ``(B, T, 3, 13)`` or cached features ``(B, T,
    2048)``. ``bb_eval`` keeps the backbone's BN on its running statistics
    in a train step; ``generator`` draws the head's dropout."""

    def forward(model, batch, train: bool, generator: Optional[torch.Generator] = None):
        x, labels, lengths = batch
        if x.ndim == 3:
            feats, bn_stats = x, []
        else:
            feats, bn_stats = xception_lstm_features(
                model, x, mode="audio", train=train and not bb_eval, compute_dtype=cdtype,
                remat=config.remat and train)
        probs = xception_lstm_head_apply(model, feats, train=train, generator=generator,
                                         lengths=lengths, mask_padding=config.mask_padding,
                                         compute_dtype=cdtype)
        w = (lengths > 0).float()
        return bce_loss(probs, labels[:, None], sample_weight=w[:, None]), bn_stats, probs

    return forward


def build(config: Config, train_ds=None, eval_ds=None):
    """-> ``(train_loader, eval_loader, state, train_step, eval_step)``."""
    check_config(config)
    device = resolve_device(config.device)
    cdtype = parse_dtype(config.compute_dtype)

    train_ds = train_ds or NpyFolderDataset(config.train_folder, kind="audio")
    eval_ds = eval_ds or NpyFolderDataset(config.eval_folder, kind="audio")
    if config.native_loader:
        from ..data.native_loader import make_native_loader

        train_loader = make_native_loader(train_ds, config.batch_size, buckets=config.buckets,
                                          seed=config.seed)
        eval_loader = make_native_loader(eval_ds, config.batch_size, buckets=config.buckets)
    else:
        train_loader = DataLoader(train_ds, config.batch_size, shuffle=False, seed=config.seed,
                                  buckets=config.buckets)
        eval_loader = DataLoader(eval_ds, config.batch_size, buckets=config.buckets)

    model = XceptionLSTM(config.hidden_dim,
                         generator=torch.Generator().manual_seed(config.seed)).to(device)
    state = TrainState(0, model, make_optimizer(model.parameters(), "adam", config.lr))
    bb_eval = config.backbone_bn_eval or config.cache_features

    if config.cache_features:
        feat_src = copy.deepcopy(model)  # main() points it at a resumed backbone

        @torch.no_grad()
        def feat_fn(x):
            with precision(cdtype):
                feats, _ = xception_lstm_features(feat_src, to_device((x,), device)[0],
                                                  mode="audio", compute_dtype=cdtype)
            return feats.float().cpu().numpy()

        train_loader = FeatureCachingLoader(train_loader, feat_fn)
        eval_loader = FeatureCachingLoader(eval_loader, feat_fn)
        train_loader.feat_src = eval_loader.feat_src = feat_src

    forward = make_forward(config, cdtype, bb_eval)

    def train_forward(model, rng_seed, batch):
        loss, bn_stats, probs = forward(model, batch, True, step_generator(device, rng_seed))
        return loss, (bn_stats, probs)

    def eval_forward(model, batch):
        loss, _, probs = forward(model, batch, False)
        return loss, probs

    raw_train_step, raw_eval_step = make_train_step(train_forward), make_eval_step(eval_forward)
    frozen = ("backbone",) if config.freeze_backbone else ()

    def train_step(state, batch, rng_seed, epoch):
        with precision(cdtype):
            return raw_train_step(state, to_device(batch, device), rng_seed, frozen)

    def eval_step(state, batch):
        with precision(cdtype):
            return raw_eval_step(state, to_device(batch, device))

    return train_loader, eval_loader, state, train_step, eval_step


def main(argv=None, *, train_ds=None, eval_ds=None, log=print):
    config = parse_config(Config, argv, prog="train_audio")
    train_loader, eval_loader, state, train_step, eval_step = build(config, train_ds, eval_ds)

    os.makedirs(config.checkpoint_dir, exist_ok=True)
    best_path = os.path.join(config.checkpoint_dir, BUNDLE_NAME)
    resume_path = os.path.join(config.checkpoint_dir, "train_audio_state.pt")
    if config.resume:
        load_state(config.resume, like=state)
        log(f"resumed train state from {config.resume} (step {state.step})")
        if config.cache_features:
            # cache features with the resumed (frozen) backbone, not the init one
            train_loader.feat_src.load_state_dict(state.model.state_dict())

    def on_best(state, result):
        save_audio_bundle(best_path, state.model)
        log(f"new best model saved -> {best_path}")

    metric_logger = epoch_logger(config, "train_audio")

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
        best_policy="loss",
        on_best=on_best,
        on_epoch=on_epoch,
        metrics_variant="basic",
        log=log,
        seed=config.seed,
    )
    history = loop.run()
    if metric_logger is not None:
        metric_logger.close()
    log("Training Finished!")
    return history


if __name__ == "__main__":
    main()
