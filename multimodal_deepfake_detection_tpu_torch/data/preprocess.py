"""Offline preprocessing: raw videos and audio -> npy trees (numpy; cv2,
scipy and torch imported where used).

The port's copy of the JAX package's ``data/preprocess.py``, keeping the
reference preprocessors' on-disk contracts:

* **UADFV faces**: decode, detect a face per frame, crop with a 20 px
  margin, resize to 256x256, keep face-bearing frames only, a fixed
  100/20/20 train/eval/test frame split per video (shorter videos skipped),
  ``{label}_{video_id}.npy`` uint8 ``(T, 256, 256, 3)``;
* **FakeAVCeleb frames**: whole frames BGR -> RGB resized to 256x256, at
  most 300, an 80/10/10 random split per subfolder,
  ``{label}_{subfolder}_{file}.npy``;
* **audio MFCC**: 16 kHz mono -> MFCC (13, 25 ms window, 10 ms hop) -> a
  fixed 120/24/24 frame split, ``{label}_{...}.npy`` float32 ``(T, 13)``.
  The MFCC is the port's ``ops/mfcc.py`` on ``device`` (CUDA by default).

Face detection is the strategy of ``face_detect``; audio comes from
``.wav`` files (scipy) or, where an ``ffmpeg`` binary exists, from a
video's audio track.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .face_detect import crop_with_margin, make_detector

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv")


def _video_frames(path: str):
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


def _resize(frame: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    import cv2

    return cv2.resize(frame, size)


def _save_splits(out_root: str, name: str, frames: np.ndarray, splits: Sequence[Tuple[str, int]]):
    start = 0
    for split, count in splits:
        d = os.path.join(out_root, split)
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{name}.npy"), frames[start : start + count])
        start += count


def process_uadfv_faces(
    dataset_root: str,
    out_root: str,
    *,
    detector: str | Callable = "center",
    detector_model: Optional[str] = None,
    margin: int = 20,
    size: int = 256,
    splits: Sequence[Tuple[str, int]] = (("train", 100), ("eval", 20), ("test", 20)),
    log=print,
) -> List[str]:
    """dataset_root/{fake,real}/*.mp4 -> out_root/{train,eval,test}/{label}_{id}.npy."""
    detect = make_detector(detector, model_path=detector_model)
    need = sum(c for _, c in splits)
    written = []
    for label in ("fake", "real"):
        folder = os.path.join(dataset_root, label)
        if not os.path.isdir(folder):
            continue
        for fname in sorted(os.listdir(folder)):
            if not fname.lower().endswith(VIDEO_EXTS):
                continue
            faces = []
            for frame in _video_frames(os.path.join(folder, fname)):
                box = detect(frame)
                if box is None:
                    continue
                faces.append(_resize(crop_with_margin(frame, box, margin), (size, size)))
                if len(faces) >= need:
                    break
            if len(faces) < need:
                log(f"[skip] {label}/{fname}: only {len(faces)} face frames (< {need})")
                continue
            video_id = os.path.splitext(fname)[0]
            _save_splits(out_root, f"{label}_{video_id}", np.stack(faces).astype(np.uint8), splits)
            written.append(f"{label}_{video_id}")
            log(f"[ok] {label}/{fname}: {need} frames")
    return written


def process_fakeavceleb_frames(
    dataset_root: str,
    out_root: str,
    *,
    size: int = 256,
    max_frames: int = 300,
    split_fracs: Tuple[float, float, float] = (0.8, 0.1, 0.1),
    seed: int = 0,
    log=print,
) -> List[str]:
    """dataset_root/{fake,real}/<subfolder>/*.mp4 -> per-subfolder 80/10/10 split."""
    rng = np.random.default_rng(seed)
    written = []
    for label in ("fake", "real"):
        base = os.path.join(dataset_root, label)
        if not os.path.isdir(base):
            continue
        for sub in sorted(os.listdir(base)):
            subdir = os.path.join(base, sub)
            if not os.path.isdir(subdir):
                continue
            files = [f for f in sorted(os.listdir(subdir)) if f.lower().endswith(VIDEO_EXTS)]
            # subfolder-level random split (FakeAVCeleb_face_dataset.py:44-54)
            order = rng.permutation(len(files))
            n = len(files)
            n_train = int(split_fracs[0] * n)
            n_eval = int(split_fracs[1] * n)
            assignment = {}
            for rank, idx in enumerate(order):
                split = "train" if rank < n_train else ("eval" if rank < n_train + n_eval else "test")
                assignment[files[idx]] = split
            for fname, split in assignment.items():
                frames = []
                for frame in _video_frames(os.path.join(subdir, fname)):
                    frames.append(_resize(frame, (size, size)))
                    if len(frames) >= max_frames:
                        break
                if not frames:
                    log(f"[skip] {label}/{sub}/{fname}: no frames")
                    continue
                d = os.path.join(out_root, split)
                os.makedirs(d, exist_ok=True)
                name = f"{label}_{sub}_{os.path.splitext(fname)[0]}"
                np.save(os.path.join(d, name + ".npy"), np.stack(frames).astype(np.uint8))
                written.append(name)
    return written


def _load_wav_16k_mono(path: str) -> np.ndarray:
    from scipy.io import wavfile
    from scipy.signal import resample_poly

    sr, data = wavfile.read(path)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if np.issubdtype(data.dtype, np.integer):
        data = data.astype(np.float32) / np.iinfo(data.dtype).max
    else:
        data = data.astype(np.float32)
    if sr != 16000:
        from math import gcd

        g = gcd(sr, 16000)
        data = resample_poly(data, 16000 // g, sr // g).astype(np.float32)
    return data


def extract_audio_ffmpeg(video_path: str, *, sr: int = 16000) -> Optional[np.ndarray]:
    """ffmpeg-based track extraction (wavfake_audio_dataset.py:30-34); None if no ffmpeg."""
    if shutil.which("ffmpeg") is None:
        return None
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tmp:
        wav = tmp.name
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-i", video_path, "-ar", str(sr), "-ac", "1", "-f", "wav", wav],
            check=True,
            capture_output=True,
        )
        return _load_wav_16k_mono(wav)
    finally:
        os.unlink(wav)


def process_audio_mfcc(
    dataset_root: str,
    out_root: str,
    *,
    sr: int = 16000,
    n_mfcc: int = 13,
    n_fft: int = 400,
    hop_length: int = 160,
    splits: Sequence[Tuple[str, int]] = (("train", 120), ("eval", 24), ("test", 24)),
    log=print,
    device: str = "cuda",
) -> List[str]:
    """dataset_root/{fake,real}/**/*.{wav,mp4} -> MFCC npy splits.

    .wav files load directly; video containers need an ffmpeg binary (skipped
    with a log line otherwise). The MFCC runs on ``device``.
    """
    import torch

    from ..ops.mfcc import mfcc as mfcc_op

    dev = torch.device(device)

    need = sum(c for _, c in splits)
    written = []
    for label in ("fake", "real"):
        base = os.path.join(dataset_root, label)
        if not os.path.isdir(base):
            continue
        for dirpath, _dirs, files in sorted(os.walk(base)):
            for fname in sorted(files):
                path = os.path.join(dirpath, fname)
                if fname.lower().endswith(".wav"):
                    audio = _load_wav_16k_mono(path)
                elif fname.lower().endswith(VIDEO_EXTS):
                    audio = extract_audio_ffmpeg(path, sr=sr)
                    if audio is None:
                        log(f"[skip] {path}: no ffmpeg for audio extraction")
                        continue
                else:
                    continue
                feats = mfcc_op(torch.from_numpy(audio).to(dev), sr=sr, n_mfcc=n_mfcc,
                                n_fft=n_fft, hop_length=hop_length).cpu().numpy()
                if feats.shape[0] < need:
                    log(f"[skip] {path}: only {feats.shape[0]} MFCC frames (< {need})")
                    continue
                rel = os.path.relpath(dirpath, base).replace(os.sep, "_")
                stem = os.path.splitext(fname)[0]
                name = f"{label}_{stem}" if rel == "." else f"{label}_{rel}_{stem}"
                _save_splits(out_root, name, feats.astype(np.float32), splits)
                written.append(name)
                log(f"[ok] {path}: {need} frames")
    return written
