"""Batch scoring CLI over the port's engines.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/serve.py`` for the
visual, audio, AV, AU-face and AU-patch engines: scores every input under
``--input`` and writes one JSONL record ``{"path", "score", "fake"}`` per
clip.

    python -m multimodal_deepfake_detection_tpu_torch.cli.serve \\
        --engine visual --ckpt_path best.npz --input clips/ --output scores.jsonl
    python -m multimodal_deepfake_detection_tpu_torch.cli.serve \\
        --engine audio --ckpt_path audio.npz --input waves/
    python -m multimodal_deepfake_detection_tpu_torch.cli.serve \\
        --engine av --ckpt_path visual.npz --audio_ckpt_path audio.npz \\
        --input clips/ --audio_input waves/
    python -m multimodal_deepfake_detection_tpu_torch.cli.serve \
        --engine au_patch --ckpt_path au_patch.npz --input patches/
    python -m multimodal_deepfake_detection_tpu_torch.cli.serve \
        --engine au_face --ckpt_path au_face.npz --input faces/ --au_input patches/

Inputs: ``visual`` and ``av`` read ``.npy`` uint8 frame stacks ``(T, H, W, 3)``
and video files (``.mp4 .avi .mov .mkv .webm``), decoded by the native
engines (``data/native_video.py``: MJPEG-AVI over libjpeg, anything else over
libav) or, per file they do not handle, by cv2, at most ``--max_frames``
frames, resized to ``--frame_size`` square (0 keeps the stream's size); the
CLI logs how many clips each engine (``mjpeg``, ``libav``, ``cv2``) served;
``audio`` reads ``.npy`` float waveforms and ``.wav`` files (through
``scipy.io.wavfile``); ``av`` pairs each clip with the waveform of the same
stem under ``--audio_input``, ``.wav`` before ``.npy``. A batch of waveforms
is zero-padded to its longest and scored without per-row sample lengths, as
the JAX CLI does, so a shorter clip's padding is scored as silence.
``au_patch`` reads ``.npy`` patch stacks ``(T, A, h, w, 3)``, each with an
optional ``<stem>_weights.npy`` ``(T, A)`` sibling (ones without), scored
with their lengths; ``au_face`` pairs each ``.npy`` face stack ``(T, H, W,
3)`` with the AU patch stack of the same stem under ``--au_input`` (its
first ``--num_aus`` AUs), masks the padded AU steps out of the attention,
and, as the JAX CLI does, scores the chunk without the clips' lengths: a
shorter clip's padded frames and AU tokens go through the biLSTMs, the
cross-attention and the pools. Float AU inputs are clipped to [0, 1] and
scaled to 0..255.

Flags are the JAX Config's fields of these engines, with the same names,
defaults and ``--field value`` syntax, plus ``--device`` and the fp path's
kernel routes. ``--quantize w8a8|w8a8-hybrid|w8a8-pallas`` serves the int8
backbone, calibrated on the first batch (the AU engines: ``w8a8`` only, the
int8 ResNet-18s). On the fp path: ``--fuse_entry
true`` runs the stride-2 blocks through the K3 kernel, ``--entry_pair true``
their separable pairs through K4; ``--middle_taps bf16`` runs K1 in bf16 tap
order; ``--fuse_exit true`` runs the exit sepconvs through K5; every option
goes to both engines of ``av``, and none to the AU engines, which raise
on them. ``--compute_dtype float32`` scores in IEEE fp32 on the card (TF32
is off for the duration of each call).

``--artifact a_T25.ptprog,a_T50.ptprog`` (or a directory of ``.ptprog``
files) scores through exported programs (``cli/export_serving.py``,
``models/artifact.py``) instead of a checkpoint, one artifact per serving
bucket, on the device type they were exported on: weights, quantization,
routes and preprocessing are baked, so ``--quantize`` and the route flags
raise with it and the model-width flags are unused. ``--use_mesh`` (ROADMAP
item 11) is not ported yet and raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from ..core.config import parse_config as _parse_config

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


@dataclasses.dataclass
class Config:
    engine: str = "visual"  # visual | audio | av | au_face | au_patch
    ckpt_path: str = "Checkpoints/XceptionLSTMV_ArcFace_Best.npz"
    input: str = "clips"
    au_input: Optional[str] = None  # au_face: the AU patch root, paired by stem
    audio_input: Optional[str] = None  # av: .wav/.npy waveform root, paired by stem
    audio_ckpt_path: str = ""  # av: the audio bundle (ckpt_path is the visual one)
    av_alpha: float = 0.5  # av: fused = alpha * p_visual + (1 - alpha) * p_audio
    output: Optional[str] = None  # JSONL path; default stdout
    batch_size: int = 8
    max_frames: int = 50
    frame_size: int = 0  # resize decoded video frames to this square; 0 = native
    hidden_dim: int = 128  # the visual head's width (audio's is audio_hidden)
    audio_hidden: int = 512
    num_aus: int = 17
    lstm_hidden: int = 256  # au_face
    patch_hidden: int = 128  # au_patch hidden_dim
    patch_lstm_hidden: int = 128
    buckets: Tuple[int, ...] = (25, 50, 75)
    sample_buckets: Tuple[int, ...] = (16000, 48000, 160000)
    compute_dtype: str = "bfloat16"
    mask_padding: bool = True
    threshold: float = 0.5  # "fake" = score > threshold in the JSONL
    # w8a8 int8 backbone ("" = fp): "w8a8", "w8a8-hybrid" (fp middle flow
    # through K1) or "w8a8-pallas" (int8 middle flow through K2); calibrates
    # on the first scored batch
    quantize: str = ""
    # fp path only: the 4 stride-2 blocks through the K3 kernel as well
    fuse_entry: bool = False
    # fp path only: the 4 stride-2 blocks' separable pairs through K4 (not
    # with fuse_entry)
    entry_pair: bool = False
    # fp path only: K1's tap order, "fp32" or "bf16" (middle_block_pallas_v2's
    # precise=False)
    middle_taps: str = "fp32"
    # fp path only: the exit sepconvs conv3 and conv4 through K5
    fuse_exit: bool = False
    device: str = "cuda"
    # serve from exported programs instead of a checkpoint: comma-separated
    # .ptprog paths and/or directories of them, one per serving bucket
    artifact: str = ""
    use_mesh: bool = False  # not ported yet (ROADMAP item 11): raises


def parse_config(argv=None) -> Config:
    """``Config()`` with ``--field value`` overrides from ``argv``."""
    return _parse_config(Config, argv, prog="serve")


def _list_inputs(folder: str, exts: Tuple[str, ...]) -> List[str]:
    out = []
    for dirpath, _dirs, files in sorted(os.walk(folder)):
        for f in sorted(files):
            if f.lower().endswith(exts) and not f.endswith("_weights.npy"):
                out.append(os.path.join(dirpath, f))
    return out


def _load_visual_item(path: str, cfg: Config) -> np.ndarray:
    """-> (T, H, W, 3) uint8; float stacks in [0, 1] are scaled to 0..255,
    videos decoded by the native engines, else cv2."""
    if path.endswith(".npy"):
        arr = np.load(path)[: cfg.max_frames]
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8) if arr.max() <= 1.5 else arr.astype(np.uint8)
        return arr
    from ..data.native_video import count_engine, decode_video

    size = (cfg.frame_size, cfg.frame_size) if cfg.frame_size else None
    arr = decode_video(path, size=size, max_frames=cfg.max_frames)
    if arr is not None:
        return (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    import cv2  # the per-file fallback

    cap = cv2.VideoCapture(path)
    frames = []
    try:
        while len(frames) < cfg.max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if cfg.frame_size:
                frame = cv2.resize(frame, (cfg.frame_size, cfg.frame_size))
            frames.append(frame)
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    count_engine("cv2")
    return np.stack(frames)


def _load_waveform(path: str) -> np.ndarray:
    """``.wav`` (integer PCM scaled to [-1, 1)) or ``.npy`` -> ``(samples,)`` fp32."""
    if path.endswith(".wav"):
        from scipy.io import wavfile

        _sr, wav = wavfile.read(path)
        wav = wav.astype(np.float32)
        if wav.ndim > 1:
            wav = wav.mean(axis=1)
        if np.abs(wav).max() > 1.5:
            wav = wav / 32768.0
        return wav
    return np.load(path).astype(np.float32).ravel()


def _pad_stack(items: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad ragged leading dims to the batch max; returns (batch, lengths)."""
    T = max(a.shape[0] for a in items)
    out = np.zeros((len(items), T) + items[0].shape[1:], items[0].dtype)
    lengths = np.zeros((len(items),), np.int32)
    for i, a in enumerate(items):
        out[i, : a.shape[0]] = a
        lengths[i] = a.shape[0]
    return out, lengths


def _to_u8(arr: np.ndarray) -> np.ndarray:
    """An AU engine's input as uint8: float clipped to [0, 1] and scaled, as
    the JAX CLI does."""
    return arr if arr.dtype == np.uint8 else (np.clip(arr, 0, 1) * 255).astype(np.uint8)


def _build_au_engine(cfg: Config):
    from ..core.precision import parse_dtype
    from ..models.serve import AUFaceScorer, AUPatchScorer

    routes = dict(fuse_entry=cfg.fuse_entry, entry_pair=cfg.entry_pair,
                  middle_taps=cfg.middle_taps != "fp32", fuse_exit=cfg.fuse_exit)
    for name, on in routes.items():
        if on:
            raise ValueError(f"--{name} is a route of the Xception engines' kernels; "
                             f"engine {cfg.engine} has none")
    common = dict(compute_dtype=parse_dtype(cfg.compute_dtype), buckets=cfg.buckets or None,
                  quantize=cfg.quantize or None, device=cfg.device)
    if cfg.engine == "au_face":
        return AUFaceScorer.from_bundle(cfg.ckpt_path, lstm_hidden=cfg.lstm_hidden, **common)
    return AUPatchScorer.from_bundle(cfg.ckpt_path, hidden_dim=cfg.patch_hidden,
                                     lstm_hidden=cfg.patch_lstm_hidden,
                                     mask_padding=cfg.mask_padding, **common)


def _build_artifact_engine(cfg: Config):
    from ..models.artifact import load_artifact_scorer

    if cfg.quantize:
        raise ValueError("--quantize is baked at export time; drop it with --artifact")
    routes = dict(fuse_entry=cfg.fuse_entry, entry_pair=cfg.entry_pair,
                  middle_taps=cfg.middle_taps != "fp32", fuse_exit=cfg.fuse_exit)
    for name, on in routes.items():
        if on:
            raise ValueError(f"--{name} is baked at export time; drop it with --artifact")
    return load_artifact_scorer([p.strip() for p in cfg.artifact.split(",") if p.strip()],
                                engine=cfg.engine, device=cfg.device)


def build_engine(cfg: Config):
    from ..core.precision import parse_dtype
    from ..models.serve import AudioScorer, AVScorer, VisualScorer

    if cfg.use_mesh:
        raise NotImplementedError("--use_mesh is not ported yet: it waits for ROADMAP item 11 "
                                  "(multi-device)")
    if cfg.artifact:
        return _build_artifact_engine(cfg)
    if cfg.engine in ("au_face", "au_patch"):
        return _build_au_engine(cfg)
    common = dict(
        compute_dtype=parse_dtype(cfg.compute_dtype), mask_padding=cfg.mask_padding,
        quantize=cfg.quantize or None, fuse_entry=cfg.fuse_entry, entry_pair=cfg.entry_pair,
        middle_taps=cfg.middle_taps, fuse_exit=cfg.fuse_exit, device=cfg.device,
    )
    visual = lambda path: VisualScorer.from_bundle(
        path, hidden_dim=cfg.hidden_dim, buckets=cfg.buckets or None, **common)
    audio = lambda path: AudioScorer.from_bundle(
        path, hidden_dim=cfg.audio_hidden, sample_buckets=cfg.sample_buckets or None, **common)
    if cfg.engine == "visual":
        return visual(cfg.ckpt_path)
    if cfg.engine == "audio":
        return audio(cfg.ckpt_path)
    if cfg.engine == "av":
        if not cfg.audio_ckpt_path:
            raise ValueError("engine av needs --audio_ckpt_path (ckpt_path = visual bundle)")
        return AVScorer(visual(cfg.ckpt_path), audio(cfg.audio_ckpt_path), alpha=cfg.av_alpha)
    raise ValueError(f"unknown engine {cfg.engine!r}; 'visual', 'audio', 'av', 'au_face' and "
                     "'au_patch' are ported")


def _audio_path(stem: str, folder: str) -> str:
    """The waveform paired with a clip: ``<stem>.wav``, else ``<stem>.npy``."""
    for ext in (".wav", ".npy"):
        path = os.path.join(folder, stem + ext)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no audio for {stem} under {folder}")


def au_patch_args(cfg: Config, chunk: List[str]) -> tuple:
    """``AUPatchScorer.score``'s arguments for the stacks of ``chunk``: the
    padded uint8 batch, the weights (ones without a ``_weights.npy``
    sibling) and the lengths."""
    items, weights = [], []
    for p in chunk:
        arr = _to_u8(np.load(p)[: cfg.max_frames])
        wp = p[:-4] + "_weights.npy"
        weights.append(np.load(wp).astype(np.float32)[: cfg.max_frames] if os.path.exists(wp)
                       else np.ones(arr.shape[:2], np.float32))
        items.append(arr)
    batch, lengths = _pad_stack(items)
    return batch, _pad_stack(weights)[0], lengths


def au_face_args(cfg: Config, chunk: List[str]) -> tuple:
    """``AUFaceScorer.score``'s arguments for the faces of ``chunk`` and their
    AU stacks paired by stem: the padded batches and the mask of the padded
    AU steps. As in the JAX CLI, no lengths: the chunk's padding is scored."""
    vids, aus = [], []
    for p in chunk:
        stem = os.path.splitext(os.path.basename(p))[0]
        ap = os.path.join(cfg.au_input, stem + ".npy")
        if not os.path.exists(ap):
            raise FileNotFoundError(f"no AU patches for {stem} under {cfg.au_input}")
        vids.append(_to_u8(np.load(p)[: cfg.max_frames]))
        aus.append(_to_u8(np.load(ap)[: cfg.max_frames, : cfg.num_aus]))
    vbatch, _ = _pad_stack(vids)
    abatch, alen = _pad_stack(aus)
    mask = (np.arange(abatch.shape[1])[None, :] < alen[:, None]).astype(np.float32)
    return vbatch, abatch, np.repeat(mask[:, :, None], abatch.shape[2], axis=2)


def _score_chunk(engine, cfg: Config, chunk: List[str]) -> np.ndarray:
    if cfg.engine == "au_patch":
        return engine.score(*au_patch_args(cfg, chunk))
    if cfg.engine == "au_face":
        return engine.score(*au_face_args(cfg, chunk))
    if cfg.engine == "visual":
        return engine.score(*_pad_stack([_load_visual_item(p, cfg) for p in chunk]))
    if cfg.engine == "audio":  # no sample lengths: the padding is scored, as in JAX
        batch, _lengths = _pad_stack([_load_waveform(p) for p in chunk])
        return engine.score(batch)
    waves = [_load_waveform(_audio_path(os.path.splitext(os.path.basename(p))[0],
                                        cfg.audio_input)) for p in chunk]
    batch, lengths = _pad_stack([_load_visual_item(p, cfg) for p in chunk])
    wbatch, _wl = _pad_stack(waves)
    return engine.score(batch, wbatch, lengths)


def main(argv=None, *, log=print) -> int:
    """Score every input under ``--input``; returns the number of records written."""
    cfg = parse_config(argv)
    engine = build_engine(cfg)
    if cfg.engine == "av" and not cfg.audio_input:
        # up front: in the loop a missing flag would surface only on the
        # first chunk, or never on an empty input directory
        raise ValueError("--audio_input (wav/npy root) required for av")
    if cfg.engine == "au_face" and not cfg.au_input:
        raise ValueError("--au_input (AU patch root) required for au_face")
    if cfg.engine in ("visual", "av"):
        exts = (".npy",) + VIDEO_EXTS
    else:
        exts = (".npy", ".wav") if cfg.engine == "audio" else (".npy",)
    paths = _list_inputs(cfg.input, exts)
    if not paths:
        raise FileNotFoundError(f"no scoreable inputs under {cfg.input}")
    log(f"[serve] {cfg.engine}: {len(paths)} inputs, batch {cfg.batch_size}, {cfg.device}")
    videos = any(p.lower().endswith(VIDEO_EXTS) for p in paths)
    if videos:
        from ..data.native_video import ENGINE_COUNTS

        served_before = dict(ENGINE_COUNTS)

    sink = open(cfg.output, "w") if cfg.output else None
    emitted = 0
    try:
        for i in range(0, len(paths), cfg.batch_size):
            chunk = paths[i : i + cfg.batch_size]
            scores = _score_chunk(engine, cfg, chunk)
            for p, s in zip(chunk, np.asarray(scores).tolist()):
                line = json.dumps({"path": p, "score": round(float(s), 6),
                                   "fake": bool(s > cfg.threshold)})
                if sink:
                    sink.write(line + "\n")
                else:
                    log(line)
                emitted += 1
    finally:
        if sink:
            sink.close()
    log(f"[serve] scored {emitted} inputs" + (f" -> {cfg.output}" if cfg.output else ""))
    if videos:
        log("[serve] clips decoded per engine: " + ", ".join(
            f"{k} {v - served_before[k]}" for k, v in ENGINE_COUNTS.items()))
    return emitted


if __name__ == "__main__":
    main()
