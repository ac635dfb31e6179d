"""Offline audio MFCC preprocessing.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/preprocess_audio.py``,
with the same flags and outputs, plus ``--device``: walks
``dataset_root/{fake,real}/``, reads 16 kHz mono audio (``.wav`` directly,
a video's track through ``ffmpeg`` where the binary exists), computes the
MFCC (13 coefficients, 25 ms window, 10 ms hop) with the port's
``ops/mfcc.py``, splits 120/24/24 frames and writes ``{label}_*.npy`` per
clip (``data/preprocess.py::process_audio_mfcc``).

    python -m multimodal_deepfake_detection_tpu_torch.cli.preprocess_audio \\
        --dataset_root raw_audio --out_root processed_audio

The MFCC runs on ``--device cuda`` unless asked for ``cpu``, and the CLI
raises if the device is missing.
"""
from __future__ import annotations

import dataclasses

from ..core.config import parse_config
from ..data.preprocess import process_audio_mfcc
from .common import resolve_device


@dataclasses.dataclass
class Config:
    dataset_root: str = "dataset"
    out_root: str = "processed_audio"
    sr: int = 16000
    n_mfcc: int = 13
    n_fft: int = 400
    hop_length: int = 160
    train_frames: int = 120
    eval_frames: int = 24
    test_frames: int = 24
    device: str = "cuda"


def main(argv=None, *, log=print):
    config = parse_config(Config, argv, prog="preprocess_audio")
    device = resolve_device(config.device)
    written = process_audio_mfcc(
        config.dataset_root, config.out_root, sr=config.sr, n_mfcc=config.n_mfcc,
        n_fft=config.n_fft, hop_length=config.hop_length,
        splits=(("train", config.train_frames), ("eval", config.eval_frames),
                ("test", config.test_frames)),
        log=log, device=str(device),
    )
    log(f"wrote {len(written)} clips -> {config.out_root}")
    return written


if __name__ == "__main__":
    main()
