"""Serving export: each engine's scoring program as a ``torch.export`` artifact.

Counterpart of ``multimodal_deepfake_detection_tpu/models/export.py``. Each
engine's device side (``_score_impl`` of the scorers in ``models/serve.py``,
the function their live ``score()`` calls) is traced by ``torch.export``
with the folded or, after ``calibrate``, the quantized backbone and every
head weight captured as constants: the calibrated scales travel as fp32
constants, the int8 weights as int8. The kernels stay one node each of the
graph (``torch.ops.mdfd.*``, ``ops/kernels/library.py``), so the program
launches them when it replays on the card.

The batch axis is symbolic by default (a ``torch.export.Dim``: one program
serves any B); the length axes (frames T, waveform samples, AU steps) are
static, one artifact per serving bucket, as in the JAX package. Host-side
work stays host-side exactly as in the live engines: callers pad to the
exported shape and slice the output (``models/artifact.py``).

An artifact is pinned to the device type it was exported on: tensors the
forward creates (``arange``, ``zeros``) carry that device in the graph, and
its constants live there. Export on the device you serve from; loading on
another device type raises rather than moving weights silently. A port
artifact is not a ``.jaxprog``, and neither package loads the other's.

Container: ``MAGIC | u32 manifest length | JSON manifest | torch.export.save
bytes``; the manifest says what the program is (engine, bucket dims, quant
mode, compute dtype, ``hop_length`` for audio, device, version). A raw
``torch.export.save`` blob loads too (:func:`read_manifest` gives None; the
engine comes from the program's signature, ``models/artifact.py``).

CLI: ``python -m multimodal_deepfake_detection_tpu_torch.cli.export_serving``.
"""
from __future__ import annotations

import io
import json
import struct
from collections import Counter
from typing import Optional, Union

import torch
from torch import nn

MAGIC = b"MDFDPT2E"  # the JAX package's container is MDFDJXPG
CONTAINER_FORMAT = 1
SUFFIX = ".ptprog"

Batch = Union[str, int]


def _wrap(program: torch.export.ExportedProgram, manifest: dict) -> bytes:
    from .. import __version__

    buf = io.BytesIO()
    torch.export.save(program, buf)
    meta = json.dumps({"format": CONTAINER_FORMAT, "version": __version__, **manifest},
                      sort_keys=True).encode()
    return MAGIC + struct.pack("<I", len(meta)) + meta + buf.getvalue()


def read_manifest(blob: bytes) -> Optional[dict]:
    """The artifact's manifest, or None for a raw ``torch.export.save`` blob."""
    if not blob.startswith(MAGIC):
        return None
    (n,) = struct.unpack("<I", blob[len(MAGIC) : len(MAGIC) + 4])
    return json.loads(blob[len(MAGIC) + 4 : len(MAGIC) + 4 + n])


def _unwrap(blob: bytes) -> bytes:
    if not blob.startswith(MAGIC):
        return blob
    (n,) = struct.unpack("<I", blob[len(MAGIC) : len(MAGIC) + 4])
    return blob[len(MAGIC) + 4 + n :]


class _Program(nn.Module):
    """The module ``torch.export`` traces: ``forward`` is the engine's
    device side, whose weights it captures as constants."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _example_batch(batch: Batch) -> int:
    """An int stays static; a name traces a symbolic batch at B = 2 (torch
    specializes sizes 0 and 1)."""
    return 2 if isinstance(batch, str) else int(batch)


def _export(fn, args: tuple, batch: Batch) -> torch.export.ExportedProgram:
    dims = None
    if isinstance(batch, str):
        dim = torch.export.Dim(batch, min=1)
        dims = {"args": tuple({0: dim} for _ in args)}  # _Program.forward's *args
    with torch.no_grad():
        return torch.export.export(_Program(fn), args, dynamic_shapes=dims)


def _quant_mode(scorer) -> Optional[str]:
    """The scorer's quant mode; raises when a quantized scorer has not been
    calibrated, since its program would have no backbone."""
    if scorer.quantize is None:
        return None
    tree = scorer.qbackbone if hasattr(scorer, "qbackbone") else scorer.qbackbones
    if tree is None:
        raise ValueError(f"calibrate() the {scorer.quantize} scorer before exporting it")
    return scorer.quantize


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _common(scorer) -> dict:
    return {"compute_dtype": _dtype_name(scorer.compute_dtype), "device": scorer.device.type}


def export_visual(scorer, T: int, H: int, W: int, *, batch: Batch = "b") -> bytes:
    """``VisualScorer`` -> artifact: ``(frames_u8 (B,T,H,W,3) uint8, lengths (B,)
    int32) -> fake probabilities (B,) float32``. ``batch``: a name for a
    symbolic batch (default), or a static int."""
    quant = _quant_mode(scorer)
    B, dev = _example_batch(batch), scorer.device
    args = (torch.zeros((B, T, H, W, 3), dtype=torch.uint8, device=dev),
            torch.full((B,), T, dtype=torch.int32, device=dev))
    program = _export(scorer._score_impl, args, batch)
    return _wrap(program, {"engine": "visual", "T": int(T), "H": int(H), "W": int(W),
                           "quant": quant, **_common(scorer)})


def export_audio(scorer, num_samples: int, *, batch: Batch = "b") -> bytes:
    """``AudioScorer`` -> artifact: ``(waveforms (B, num_samples) float32,
    frame_lengths (B,) int32) -> fake probabilities (B,)``.

    The librosa-centred MFCC path (the unbucketed ``score()``): waveforms
    arrive raw and are reflect-centred on the device. ``frame_lengths`` gates
    the LSTM; pass ``1 + num_samples // hop_length`` for full-length clips."""
    quant = _quant_mode(scorer)
    B, dev = _example_batch(batch), scorer.device
    hop = int(scorer.mfcc_kw["hop_length"])
    args = (torch.zeros((B, int(num_samples)), dtype=torch.float32, device=dev),
            torch.full((B,), 1 + int(num_samples) // hop, dtype=torch.int32, device=dev))
    program = _export(lambda w, fl: scorer._score_impl(w, fl, True), args, batch)
    return _wrap(program, {"engine": "audio", "num_samples": int(num_samples),
                           "hop_length": hop, "quant": quant, **_common(scorer)})


def export_au_face(scorer, T: int, Ta: int, A: int, face_hw, patch_hw, *,
                   batch: Batch = "b") -> bytes:
    """``AUFaceScorer`` -> artifact: ``(videos_u8 (B,T,H,W,3) uint8,
    au_patches_u8 (B,Ta,A,h,w,3) uint8, au_mask (B,Ta,A) f32, au_weight
    (B,Ta,A) f32) -> fake probabilities (B,)``. The valid lengths are baked
    to the exported ``(T, Ta)``: one ``(T, Ta)`` bucket of the live engine."""
    quant = _quant_mode(scorer)
    B, dev = _example_batch(batch), scorer.device
    (H, W), (h, w) = face_hw, patch_hw
    args = (torch.zeros((B, T, H, W, 3), dtype=torch.uint8, device=dev),
            torch.zeros((B, Ta, A, h, w, 3), dtype=torch.uint8, device=dev),
            torch.ones((B, Ta, A), dtype=torch.float32, device=dev),
            torch.ones((B, Ta, A), dtype=torch.float32, device=dev))
    program = _export(lambda v, p, m, wt: scorer._score_impl(v, p, m, wt, int(T), int(Ta)),
                      args, batch)
    return _wrap(program, {"engine": "au_face", "T": int(T), "Ta": int(Ta), "A": int(A),
                           "face_hw": [int(H), int(W)], "patch_hw": [int(h), int(w)],
                           "quant": quant, **_common(scorer)})


def export_au_patch(scorer, T: int, A: int, patch_hw, *, batch: Batch = "b") -> bytes:
    """``AUPatchScorer`` -> artifact: ``(patches_u8 (B,T,A,h,w,3) uint8,
    au_weights (B,T,A) f32, lengths (B,) int32) -> fake probabilities (B,)``."""
    quant = _quant_mode(scorer)
    B, dev = _example_batch(batch), scorer.device
    h, w = patch_hw
    args = (torch.zeros((B, T, A, h, w, 3), dtype=torch.uint8, device=dev),
            torch.ones((B, T, A), dtype=torch.float32, device=dev),
            torch.full((B,), T, dtype=torch.int32, device=dev))
    program = _export(scorer._score_impl, args, batch)
    return _wrap(program, {"engine": "au_patch", "T": int(T), "A": int(A),
                           "patch_hw": [int(h), int(w)], "quant": quant, **_common(scorer)})


def export_av(av_scorer, T: int, H: int, W: int, num_samples: int, *,
              batch: Batch = "b") -> bytes:
    """``AVScorer`` -> one artifact scoring both modalities: ``(frames_u8
    (B,T,H,W,3) uint8, lengths (B,) int32, waveforms (B, num_samples)
    float32, frame_lengths (B,) int32) -> alpha * p_visual + (1 - alpha) *
    p_audio (B,)``."""
    vis, aud = av_scorer.visual, av_scorer.audio
    if vis.device != aud.device:
        raise ValueError(f"the AV engines run on {vis.device} and {aud.device}: export needs one")
    quant = [_quant_mode(vis), _quant_mode(aud)]
    B, dev = _example_batch(batch), vis.device
    hop = int(aud.mfcc_kw["hop_length"])
    args = (torch.zeros((B, T, H, W, 3), dtype=torch.uint8, device=dev),
            torch.full((B,), T, dtype=torch.int32, device=dev),
            torch.zeros((B, int(num_samples)), dtype=torch.float32, device=dev),
            torch.full((B,), 1 + int(num_samples) // hop, dtype=torch.int32, device=dev))
    program = _export(av_scorer._score_impl, args, batch)
    return _wrap(program, {"engine": "av", "T": int(T), "H": int(H), "W": int(W),
                           "num_samples": int(num_samples), "alpha": float(av_scorer.alpha),
                           "hop_length": hop, "quant": quant,
                           "compute_dtype": [_dtype_name(vis.compute_dtype),
                                             _dtype_name(aud.compute_dtype)],
                           "device": dev.type})


def program_device(program: torch.export.ExportedProgram) -> str:
    """The device type an exported program's constants live on."""
    for t in list(program.state_dict.values()) + list(program.constants.values()):
        if isinstance(t, torch.Tensor):
            return t.device.type
    return "cpu"


def load_exported(blob: bytes, device=None) -> torch.export.ExportedProgram:
    """Deserialize an artifact (a container or a raw ``torch.export.save``
    blob); run it through ``.module()``. ``device``: the device it will
    serve on; an artifact exported on another device type raises."""
    from ..ops.kernels import library  # noqa: F401  (the ops its graph calls)

    manifest = read_manifest(blob)
    if device is not None and manifest is not None:
        _check_device(manifest["device"], device)
    program = torch.export.load(io.BytesIO(_unwrap(blob)))
    if device is not None:
        _check_device(program_device(program), device)
    return program


def _check_device(exported_on: str, device) -> None:
    if torch.device(device).type != exported_on:
        raise ValueError(f"the artifact was exported on {exported_on}; it cannot serve on "
                         f"{torch.device(device)}: export it again on that device")


def kernel_nodes(program: torch.export.ExportedProgram) -> dict:
    """The ``torch.ops.mdfd`` nodes of a program's graph, by the launch
    counter each adds to when it replays on the card."""
    from ..ops.kernels.library import kernel_counter

    counts = Counter(kernel_counter(node) for node in program.graph.nodes)
    counts.pop("", None)
    return dict(counts)
