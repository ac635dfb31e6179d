"""Train the AU-patch attention classifier (ResNet-18 + biLSTM) on patch trees.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/train_au_patch.py``,
with the same ``Config`` fields and defaults: the AU patch loaders (train
balanced, augmented and shuffled; eval augmented), the classifier (hidden
128, biLSTM 128) trained unfrozen with its ResNet-18 in batch-statistics BN,
label-smoothing (0.1) BCE on the logits, Adam 1e-4 with L2 decay 1e-4 and
clip 1.0, plateau LR (factor 0.5, patience 4), early stop after 5 epochs
without a best eval loss, batch 2, 60 frames x 17 AUs at 128^2. The best
``{model, state}`` bundle is written in the JAX layout, so both packages'
``AUPatchScorer.from_bundle`` (and the port's ``cli/serve.py --engine
au_patch``) serve it.

    python -m multimodal_deepfake_detection_tpu_torch.cli.train_au_patch \\
        --data_root patches --checkpoint_dir ckpt

The metric probabilities keep the reference's temperatures:
``sigmoid(logits / 7)`` in training, ``sigmoid(logits / 2)`` in eval, where
the scorers serve ``sigmoid(logits)``. It trains on ``--device cuda``
unless asked for ``cpu``, and raises if the device is missing;
``--compute_dtype float32`` runs IEEE fp32 (TF32 off). ``--resume`` takes a
``train_au_patch_state.pt`` snapshot; ``--ckpt_backend orbax`` keeps
versioned step directories under ``train_au_patch_orbax``
(``core/orbax_ckpt.py``) and ``--resume auto`` restores the newest.
``--jsonl_log`` and ``--tracker`` log each epoch as in JAX
(``utils/metric_logger.py``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

from ..core.config import parse_config
from ..core.precision import at_least_f32, parse_dtype
from ..data.au_patches import get_patch_image_loaders
from ..models.losses import label_smoothing_bce_loss
from ..models.resnet_lstm import AUPatchClassifier, au_patch_classifier_apply
from ..train import PlateauScheduler, TrainLoop, TrainState, make_optimizer
from ..train.steps import make_eval_step, make_train_step
from ..utils.jax_weights import save_au_patch_bundle
from .common import (
    ResumeState,
    check_ckpt_backend,
    epoch_logger,
    precision,
    resolve_device,
    to_device,
)

TRAIN_TEMP = 7.0  # the reference's metric temperature in training
EVAL_TEMP = 2.0  # and in eval


@dataclasses.dataclass
class Config:
    """train_au_patch configuration (defaults = the JAX CLI's)."""

    data_root: str = "Dataset/AU_Files/fakeavceleb_whole_image_patches"
    # labels and splits from a FakeAVCeleb csv or a LAV-DF json; without
    # either, the flat {data_root}/{split} trees with filename labels
    mode: str = "fakeavceleb"
    csv_path: Optional[str] = None
    lavdf_json: Optional[str] = None
    include_unmatched_real: bool = False
    unmatched_split_seed: int = 42
    num_workers: int = 0
    checkpoint_dir: str = "Checkpoints"
    bundle_name: str = "best_au_patch_model.npz"
    hidden_dim: int = 128
    lstm_hidden: int = 128
    batch_size: int = 2
    image_size: int = 128
    max_frames: int = 60
    max_aus: int = 17
    label_smoothing: float = 0.1
    lr: float = 1e-4
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    epochs: int = 100
    early_stop_patience: int = 5
    plateau_factor: float = 0.5
    plateau_patience: int = 4
    augment_train: bool = True
    augment_eval: bool = True
    augment_test: bool = False
    seed: int = 0
    compute_dtype: str = "bfloat16"
    buckets: Tuple[int, ...] = ()
    mask_padding: bool = True
    jsonl_log: Optional[str] = None
    tracker: Optional[str] = None
    ckpt_backend: str = "npz"
    resume: Optional[str] = None  # a train_au_patch_state.pt snapshot
    save_resume_state: bool = True
    device: str = "cuda"


def check_config(config: Config) -> None:
    """Raise on a flag value the CLI has no path for, never ignore it."""
    check_ckpt_backend(config)


class LoopLoader:
    """``(patches, weights, labels, lengths)`` batches regrouped as the
    loop's ``((patches, weights), labels, lengths)``."""

    def __init__(self, loader):
        self.loader = loader
        self.dataset = loader.dataset

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for patches, weights, labels, lengths in self.loader:
            yield (patches, weights), labels, lengths


def make_forward(config: Config, cdtype: torch.dtype):
    """The CLI's loss forward: ``forward(model, batch, train) -> (loss,
    bn_stats, probs)`` on a device batch ``((patches, weights), labels,
    lengths)``, probabilities at the train or eval temperature."""

    def forward(model, batch, train: bool):
        (patches, weights), labels, lengths = batch
        out = au_patch_classifier_apply(model, patches, weights, lengths=lengths,
                                        mask_padding=config.mask_padding, compute_dtype=cdtype,
                                        train=train)
        logits, bn_stats = out if train else (out, [])
        logits = logits[:, 0]
        loss = label_smoothing_bce_loss(logits, labels, config.label_smoothing,
                                        sample_weight=(lengths > 0).float())
        probs = torch.sigmoid(at_least_f32(logits) / (TRAIN_TEMP if train else EVAL_TEMP))
        return loss, bn_stats, probs

    return forward


def build(config: Config):
    """-> ``(train_loader, eval_loader, test_loader, state, train_step,
    eval_step)``."""
    check_config(config)
    device = resolve_device(config.device)
    cdtype = parse_dtype(config.compute_dtype)
    train_l, test_l, eval_l = get_patch_image_loaders(
        config.data_root, mode=config.mode, csv_path=config.csv_path,
        lavdf_json=config.lavdf_json, include_unmatched_real=config.include_unmatched_real,
        unmatched_split_seed=config.unmatched_split_seed, num_workers=config.num_workers,
        batch_size=config.batch_size, image_size=config.image_size,
        max_frames=config.max_frames, max_aus=config.max_aus, buckets=config.buckets or None,
        augment_train=config.augment_train, augment_eval=config.augment_eval,
        augment_test=config.augment_test, seed=config.seed)

    model = AUPatchClassifier(config.hidden_dim, config.lstm_hidden,
                              generator=torch.Generator().manual_seed(config.seed)).to(device)
    opt = make_optimizer(model.parameters(), "adam", config.lr,
                         weight_decay=config.weight_decay, grad_clip=config.grad_clip)
    state = TrainState(0, model, opt)
    forward = make_forward(config, cdtype)

    def train_forward(model, rng_seed, batch):
        loss, bn_stats, probs = forward(model, batch, True)
        return loss, (bn_stats, probs)

    def eval_forward(model, batch):
        loss, _, probs = forward(model, batch, False)
        return loss, probs

    raw_train_step, raw_eval_step = make_train_step(train_forward), make_eval_step(eval_forward)

    def train_step(state, batch, rng_seed, epoch):
        with precision(cdtype):
            return raw_train_step(state, to_device(batch, device), rng_seed)

    def eval_step(state, batch):
        with precision(cdtype):
            return raw_eval_step(state, to_device(batch, device))

    return (LoopLoader(train_l), LoopLoader(eval_l), LoopLoader(test_l), state, train_step,
            eval_step)


def main(argv=None, *, log=print):
    config = parse_config(Config, argv, prog="train_au_patch")
    train_loader, eval_loader, _test_loader, state, train_step, eval_step = build(config)

    os.makedirs(config.checkpoint_dir, exist_ok=True)
    best_path = os.path.join(config.checkpoint_dir, config.bundle_name)
    snapshots = ResumeState(config, "train_au_patch")
    snapshots.resume(state, config.resume, log)

    def on_best(state, result):
        save_au_patch_bundle(best_path, state.model)
        log(f"model saved -> {best_path}")

    metric_logger = epoch_logger(config, "train_au_patch")

    def on_epoch(state, result):
        if config.save_resume_state:
            snapshots.save(state, result.epoch)
        if metric_logger is not None:
            metric_logger.log_epoch(result)

    loop = TrainLoop(
        train_step=train_step,
        eval_step=eval_step,
        state=state,
        train_loader=train_loader,
        eval_loader=eval_loader,
        num_epochs=config.epochs,
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
    log("Training Complete.")
    return history


if __name__ == "__main__":
    main()
