"""Export a serving engine's scoring program to an artifact.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/export_serving.py``:
writes a ``torch.export`` program (``models/export.py``) with the engine's
weights captured as constants and its device-side preprocessing in the
graph, servable with no model code or checkpoint
(``models/artifact.py::ArtifactScorer``, ``cli/serve.py --artifact``,
``cli/serve_daemon.py --artifact``). The batch axis is symbolic (one
artifact serves any B) unless ``--batch`` is an int; the length axes are
static, one artifact per serving bucket.

    python -m multimodal_deepfake_detection_tpu_torch.cli.export_serving \\
        --engine visual --ckpt_path best.npz --frames 50 --size 256 \\
        --out visual_T50.ptprog

The program is pinned to ``--device`` (default ``cuda``): export on the
device type you serve from; it launches the port's kernels there as the
live engine does. With ``--quantize`` and ``--calib_npy`` (a representative
input batch) it bakes the w8a8 backbone (int8 weights, calibrated scales);
``--refine_passes N`` adds the affine refinement on the calibration batch
(visual, audio, au_patch). ``--fuse_entry``, ``--entry_pair``,
``--middle_taps`` and ``--fuse_exit`` choose the fp path's kernel routes as
in ``cli/serve.py``. Flags are the JAX Config's, with ``--device`` in place
of ``--platforms``.
"""
from __future__ import annotations

import dataclasses

from ..core.config import parse_config


@dataclasses.dataclass
class Config:
    engine: str = "visual"  # visual | audio | au_face | au_patch | av
    ckpt_path: str = "Checkpoints/XceptionLSTMV_ArcFace_Best.npz"
    audio_ckpt_path: str = ""  # av: the audio bundle (ckpt_path = visual)
    av_alpha: float = 0.5  # av: fused score = alpha*visual + (1-alpha)*audio
    out: str = "scoring_program.ptprog"
    # static length axes of the exported program (one artifact per bucket)
    frames: int = 50  # visual/au_face T
    size: int = 256  # visual frame H=W
    num_samples: int = 48000  # audio waveform length
    au_frames: int = 50  # au_face Ta / au_patch T
    num_aus: int = 17
    patch_size: int = 32  # au_face/au_patch patch h=w
    # model widths (as in cli/serve.py)
    hidden_dim: int = 128
    audio_hidden: int = 512
    lstm_hidden: int = 256
    patch_hidden: int = 128
    patch_lstm_hidden: int = 128
    compute_dtype: str = "bfloat16"
    mask_padding: bool = True
    batch: str = "b"  # symbolic batch dim name; an int string bakes it static
    quantize: str = ""  # "" | w8a8 | w8a8-hybrid | w8a8-pallas (visual; others w8a8)
    calib_npy: str = ""  # representative batch for --quantize calibration
    refine_passes: int = 0  # >0: affine PTQ refinement on the calib batch (visual/audio/au_patch)
    # the fp path's kernel routes (visual, audio, av), as in cli/serve.py
    fuse_entry: bool = False
    entry_pair: bool = False
    middle_taps: str = "fp32"
    fuse_exit: bool = False
    device: str = "cuda"


def main(argv=None, *, log=print) -> str:
    """Export one engine's program to ``--out``; returns the path."""
    cfg = parse_config(Config, argv, prog="export_serving")
    import numpy as np

    from ..core.precision import parse_dtype
    from ..models import export as E
    from ..models import serve as S
    from .common import resolve_device

    device = resolve_device(cfg.device)
    batch = int(cfg.batch) if cfg.batch.isdigit() else cfg.batch
    common = dict(compute_dtype=parse_dtype(cfg.compute_dtype), quantize=cfg.quantize or None,
                  device=device)
    routes = dict(fuse_entry=cfg.fuse_entry, entry_pair=cfg.entry_pair,
                  middle_taps=cfg.middle_taps, fuse_exit=cfg.fuse_exit)
    calib = np.load(cfg.calib_npy) if cfg.calib_npy else None
    if cfg.quantize and calib is None:
        raise ValueError("--quantize requires --calib_npy (a representative input batch)")
    if cfg.refine_passes and cfg.engine not in ("visual", "audio", "au_patch"):
        raise ValueError(
            "--refine_passes needs a single-input calibratable engine (visual/audio/au_patch)")
    if cfg.refine_passes and not cfg.quantize:
        raise ValueError("--refine_passes refines a quantized backbone; set --quantize too")
    if cfg.engine in ("au_face", "au_patch") and (
            cfg.fuse_entry or cfg.entry_pair or cfg.middle_taps != "fp32" or cfg.fuse_exit):
        raise ValueError(f"the kernel routes belong to the Xception engines; engine "
                         f"{cfg.engine} has none")
    refine = dict(refine_passes=cfg.refine_passes)

    if cfg.engine == "visual":
        scorer = S.VisualScorer.from_bundle(cfg.ckpt_path, hidden_dim=cfg.hidden_dim,
                                            mask_padding=cfg.mask_padding, **common, **routes)
        if calib is not None:
            scorer.calibrate(calib, **refine)
        blob = E.export_visual(scorer, T=cfg.frames, H=cfg.size, W=cfg.size, batch=batch)
    elif cfg.engine == "audio":
        scorer = S.AudioScorer.from_bundle(cfg.ckpt_path, hidden_dim=cfg.audio_hidden,
                                           mask_padding=cfg.mask_padding, **common, **routes)
        if calib is not None:
            scorer.calibrate(calib, **refine)
        blob = E.export_audio(scorer, cfg.num_samples, batch=batch)
    elif cfg.engine == "au_face":
        if calib is not None:
            raise ValueError("au_face export: calibrate through the Python API (two inputs)")
        scorer = S.AUFaceScorer.from_bundle(cfg.ckpt_path, lstm_hidden=cfg.lstm_hidden,
                                            **common)
        blob = E.export_au_face(scorer, T=cfg.frames, Ta=cfg.au_frames, A=cfg.num_aus,
                                face_hw=(cfg.size, cfg.size),
                                patch_hw=(cfg.patch_size, cfg.patch_size), batch=batch)
    elif cfg.engine == "av":
        if not cfg.audio_ckpt_path:
            raise ValueError("engine av needs --audio_ckpt_path (ckpt_path = visual bundle)")
        if calib is not None:
            raise ValueError("av export: calibrate the two engines through the Python API")
        av = S.AVScorer.from_bundles(cfg.ckpt_path, cfg.audio_ckpt_path, alpha=cfg.av_alpha,
                                     hidden_dim=cfg.hidden_dim, audio_hidden=cfg.audio_hidden,
                                     mask_padding=cfg.mask_padding, **common, **routes)
        blob = E.export_av(av, T=cfg.frames, H=cfg.size, W=cfg.size,
                           num_samples=cfg.num_samples, batch=batch)
    elif cfg.engine == "au_patch":
        scorer = S.AUPatchScorer.from_bundle(cfg.ckpt_path, hidden_dim=cfg.patch_hidden,
                                             lstm_hidden=cfg.patch_lstm_hidden,
                                             mask_padding=cfg.mask_padding, **common)
        if calib is not None:
            scorer.calibrate(calib, **refine)
        blob = E.export_au_patch(scorer, T=cfg.au_frames, A=cfg.num_aus,
                                 patch_hw=(cfg.patch_size, cfg.patch_size), batch=batch)
    else:
        raise ValueError(f"unknown engine {cfg.engine!r}")

    with open(cfg.out, "wb") as f:
        f.write(blob)
    log(f"[export_serving] {cfg.engine}: wrote {len(blob) / 1e6:.1f} MB -> {cfg.out}")
    return cfg.out


if __name__ == "__main__":
    main()
