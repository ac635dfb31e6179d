"""Fused audio-visual evaluation over paired face and MFCC trees.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/test_av_fused.py``,
with the same ``Config`` fields and defaults: clips are paired across the
two npy trees by filename stem (the labels must agree), both streams of a
batch are scored in one call (XceptionLSTMV + ArcFace softmax, XceptionLSTMA
sigmoid), and the fused score ``alpha * p_visual + (1 - alpha) * p_audio``
is reported with the full metric suite beside each single stream.
``--save_scores`` writes ``labels``, ``visual``, ``audio`` and ``fused``.

    python -m multimodal_deepfake_detection_tpu_torch.cli.test_av_fused \\
        --video_folder faces/test --audio_folder mfcc/test \\
        --visual_ckpt ckpt/visual.npz --audio_ckpt ckpt/audio.npz

It scores through the unfolded eval-BN Xceptions (no kernel of the port's
own) on ``--device cuda`` unless asked for ``cpu``, and raises if the
device is missing; ``--compute_dtype float32`` runs IEEE fp32 (TF32 off).
Like the JAX CLI's data mesh, each batch is sharded over the first
``gcd(batch_size, n)`` of the ``n`` devices of ``--device``'s type
(``parallel/mesh.py``), each with a replica of both models, and the
probabilities are gathered in order; one device scores unsharded.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.checkpoint import load_bundle
from ..core.config import parse_config
from ..core.precision import parse_dtype
from ..data.collate import pad_collate
from ..data.datasets import NpyFolderDataset, label_from_filename
from ..data.loader import DataLoader
from ..metrics import compute_metrics_interp
from ..models.heads import (
    ArcFace,
    arcface_apply,
    xception_lstm_embed,
    xception_lstm_features,
    xception_lstm_head_apply,
)
from ..models.serve import load_visual_bundle, merge_xception_lstm
from ..parallel.mesh import auto_data_mesh, local_devices, map_shards, replicas
from .common import precision, resolve_device


@dataclasses.dataclass
class Config:
    video_folder: str = "Dataset/processed/test"
    audio_folder: str = "Dataset/processed_audio/test"
    visual_ckpt: str = "Checkpoints/XceptionLSTMV_ArcFace_Best.npz"
    audio_ckpt: str = "Checkpoints/best_model_audio.npz"
    visual_hidden: int = 128
    audio_hidden: int = 512
    arcface_s: float = 30.0
    alpha: float = 0.5  # fusion weight on the visual stream
    batch_size: int = 4
    max_frames: int = 75
    video_buckets: Tuple[int, ...] = (25, 50, 75)
    audio_buckets: Tuple[int, ...] = (120,)
    compute_dtype: str = "bfloat16"
    mask_padding: bool = True
    save_scores: Optional[str] = None
    seed: int = 0
    device: str = "cuda"


class PairedAVDataset:
    """Pairs {label}_{id}.npy across a face tree and an MFCC tree by stem."""

    def __init__(self, video_folder: str, audio_folder: str, *, max_frames: Optional[int] = None):
        self.video = NpyFolderDataset(video_folder, kind="video", max_frames=max_frames)
        self.audio = NpyFolderDataset(audio_folder, kind="audio")
        vstems = {os.path.basename(f)[:-4]: i for i, f in enumerate(self.video.files)}
        astems = {os.path.basename(f)[:-4]: i for i, f in enumerate(self.audio.files)}
        self.stems = sorted(set(vstems) & set(astems))
        self._v_idx = [vstems[s] for s in self.stems]
        self._a_idx = [astems[s] for s in self.stems]
        self.all_labels = [label_from_filename(s + ".npy") for s in self.stems]

    def __len__(self):
        return len(self.stems)

    def __getitem__(self, idx: int):
        v, yv = self.video[self._v_idx[idx]]
        a, ya = self.audio[self._a_idx[idx]]
        assert yv == ya
        return v, a, yv


def _av_collate(items, *, video_buckets, audio_buckets, batch_size):
    videos = pad_collate([(v, y) for v, _a, y in items], buckets=video_buckets,
                         batch_size=batch_size)
    audios = pad_collate([(a, y) for _v, a, y in items], buckets=audio_buckets,
                         batch_size=batch_size)
    vb, labels, v_len = videos
    ab, _labels, a_len = audios
    return (vb, ab, a_len), labels, v_len


class Scorer:
    """Both eval models: ``probs(videos, v_len, audios, a_len)``
    -> ``(p_visual, p_audio)`` fp32 device tensors; called on a host batch
    ``((videos, audios, a_len), labels, v_len)``, the same as numpy, its
    rows sharded over ``mesh`` (a device list whose first device is
    ``device``; that one alone without it)."""

    def __init__(self, visual, arcface: ArcFace, audio, config: Config, device: torch.device,
                 mesh=None):
        self.visual, self.arcface, self.audio = visual, arcface, audio
        self.config, self.device = config, device
        self.cdtype = parse_dtype(config.compute_dtype)
        self.replicas = replicas(self, mesh or [device], ("visual", "arcface", "audio"))

    def probs(self, videos, v_len, audios, a_len):
        cfg, cd = self.config, self.cdtype
        v_feats, _ = xception_lstm_features(self.visual, videos, mode="video", compute_dtype=cd)
        emb = xception_lstm_embed(self.visual, v_feats, lengths=v_len,
                                  mask_padding=cfg.mask_padding, compute_dtype=cd)
        p_v = torch.softmax(arcface_apply(self.arcface.w, emb, None, s=cfg.arcface_s), -1)[:, 1]
        a_feats, _ = xception_lstm_features(self.audio, audios, mode="audio", compute_dtype=cd)
        p_a = xception_lstm_head_apply(self.audio, a_feats, lengths=a_len,
                                       mask_padding=cfg.mask_padding, compute_dtype=cd)[:, 0]
        return p_v.float(), p_a.float()

    @torch.no_grad()
    def __call__(self, batch):
        (videos, audios, a_len), _labels, v_len = batch
        with precision(self.cdtype):
            p_v, p_a = map_shards(self.replicas, lambda r, *blocks: r.probs(*blocks),
                                  (videos, v_len, audios, a_len))
        return p_v.numpy(), p_a.numpy()


def build_scorer(config: Config, devices=None, log=print) -> Scorer:
    """Both bundles on ``config.device``; the batches shard over
    ``auto_data_mesh`` of ``devices`` (by default every device of that
    type)."""
    device = resolve_device(config.device)
    visual, arc = load_visual_bundle(config.visual_ckpt, config.visual_hidden, seed=config.seed)
    audio = merge_xception_lstm(load_bundle(config.audio_ckpt), config.audio_hidden,
                                torch.Generator().manual_seed(config.seed))
    mesh = auto_data_mesh(config.batch_size, devices=devices or local_devices(config.device))
    if mesh is not None:
        device = mesh[0]
        log(f"sharded AV eval over {len(mesh)} devices")
    frozen = lambda m: m.to(device).eval().requires_grad_(False)  # noqa: E731
    return Scorer(frozen(visual), frozen(arc), frozen(audio), config, device, mesh)


def make_loader(config: Config, log=print) -> DataLoader:
    ds = PairedAVDataset(config.video_folder, config.audio_folder, max_frames=config.max_frames)
    if len(ds) == 0:
        raise FileNotFoundError("no paired clips between video_folder and audio_folder")
    log(f"paired clips: {len(ds)}")
    return DataLoader(
        ds,
        config.batch_size,
        collate=lambda items: _av_collate(
            items,
            video_buckets=config.video_buckets,
            audio_buckets=config.audio_buckets,
            batch_size=config.batch_size,
        ),
    )


def evaluate(score_fn, loader):
    """-> ``(labels, p_visual, p_audio)`` of the rows with ``v_len > 0``."""
    pv_all, pa_all, y_all = [], [], []
    for batch, labels, v_len in loader:
        p_v, p_a = score_fn((batch, labels, v_len))
        mask = np.asarray(v_len) > 0
        pv_all.extend(p_v[mask].tolist())
        pa_all.extend(p_a[mask].tolist())
        y_all.extend(labels[mask].astype(int).tolist())
    return np.asarray(y_all), np.asarray(pv_all), np.asarray(pa_all)


def main(argv=None, *, log=print):
    config = parse_config(Config, argv, prog="test_av_fused")
    loader = make_loader(config, log)
    score_fn = build_scorer(config, log=log)
    y, p_v, p_a = evaluate(score_fn, loader)
    fused = config.alpha * p_v + (1 - config.alpha) * p_a
    results = {}
    for name, s in (("visual", p_v), ("audio", p_a), ("fused", fused)):
        m = compute_metrics_interp(y, s)
        results[name] = m
        log(f"[{name}] AUC={m['AUC']:.4f} AP={m['AP']:.4f} pAUC={m['pAUC']:.4f} EER={m['EER']:.4f}")
    if config.save_scores:
        os.makedirs(os.path.dirname(os.path.abspath(config.save_scores)), exist_ok=True)
        np.savez(config.save_scores, labels=y, visual=p_v, audio=p_a, fused=fused)
        log(f"saved scores -> {config.save_scores}")
    return results


if __name__ == "__main__":
    main()
