"""Offline face and frame preprocessing (UADFV and FakeAVCeleb modes).

Counterpart of ``multimodal_deepfake_detection_tpu/cli/preprocess_faces.py``,
with the same flags and outputs. Reads the reference's raw layout,
``dataset_root/{fake,real}/...``, and writes the npy trees the loaders read
(``data/preprocess.py``): ``--mode uadfv`` face crops (``--detector center
| none | yunet --detector_model <onnx>``, ``--margin``, 100/20/20 frames a
video), ``--mode fakeavceleb`` whole frames (at most ``--max_frames``, an
80/10/10 split per subfolder from ``--seed``), all at ``--size``.

    python -m multimodal_deepfake_detection_tpu_torch.cli.preprocess_faces \\
        --dataset_root raw --out_root processed --mode uadfv

Host work only (cv2 decode, crop and resize); nothing runs on a device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.config import parse_config
from ..data.preprocess import process_fakeavceleb_frames, process_uadfv_faces


@dataclasses.dataclass
class Config:
    dataset_root: str = "dataset"
    out_root: str = "processed"
    mode: str = "uadfv"  # 'uadfv' (face crops) | 'fakeavceleb' (full frames)
    detector: str = "center"  # 'center' | 'none' | 'yunet'
    detector_model: Optional[str] = None  # ONNX path for yunet
    margin: int = 20
    size: int = 256
    max_frames: int = 300  # fakeavceleb cap
    seed: int = 0


def main(argv=None, *, log=print):
    config = parse_config(Config, argv, prog="preprocess_faces")
    if config.mode == "uadfv":
        written = process_uadfv_faces(
            config.dataset_root, config.out_root, detector=config.detector,
            detector_model=config.detector_model, margin=config.margin, size=config.size,
            log=log,
        )
    elif config.mode == "fakeavceleb":
        written = process_fakeavceleb_frames(
            config.dataset_root, config.out_root, size=config.size,
            max_frames=config.max_frames, seed=config.seed, log=log,
        )
    else:
        raise ValueError(f"unknown mode {config.mode!r}")
    log(f"wrote {len(written)} items -> {config.out_root}")
    return written


if __name__ == "__main__":
    main()
