"""Artifact-backed serving: the live engines' ``score()`` over exported programs.

Counterpart of ``multimodal_deepfake_detection_tpu/models/artifact.py``.
``models/export.py`` writes ``torch.export`` scoring programs (weights baked,
preprocessing fused); :class:`ArtifactScorer` gives them the same
``score()`` surface as the live engines in ``models/serve.py``, with
multi-artifact bucket dispatch, so ``cli/serve.py``, ``cli/serve_daemon.py``
and the micro-batching adapters (``serving/batcher.py``) run from artifacts
alone, with no checkpoint and no calibration data.

The engine comes from the container's manifest; for a raw
``torch.export.save`` blob it comes from the program's calling convention,
which each engine's has uniquely (arity, ndim, dtype kind):

========  =====================================================================
engine    exported positional args (B symbolic or static)
========  =====================================================================
visual    frames (B,T,H,W,3) u8, lengths (B,) i32
audio     waveforms (B,S) f32, frame_lengths (B,) i32
au_patch  patches (B,T,A,h,w,3) u8, weights (B,T,A) f32, lengths (B,) i32
au_face   videos (B,T,H,W,3) u8, patches (B,Ta,A,h,w,3) u8,
          au_mask (B,Ta,A) f32, au_weight (B,Ta,A) f32
av        frames (B,T,H,W,3) u8, lengths (B,) i32,
          waveforms (B,S) f32, frame_lengths (B,) i32
========  =====================================================================

Bucket dispatch mirrors the live engines (``data/collate.py::bucket_length``):
the smallest artifact whose static length axis covers the input is chosen,
the input zero-padded up to it (lengths clipped), and inputs longer than the
largest artifact are cut to it. ``au_face`` artifacts bake their valid
lengths (``export_au_face``), so they need an exact ``(T, Ta)`` match:
padding would change the gating.

A program runs on the device type it was exported on (``models/export.py``).
One whose manifest says fp32 runs in IEEE fp32 (``core/precision.py::
ieee_fp32``, as the live scorers' ``_ieee_fp32``): TF32 is a global switch
of cuDNN and cuBLAS, which the exported graph does not carry.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.precision import ieee_fp32
from ..data.collate import bucket_length
from .export import SUFFIX, load_exported, program_device, read_manifest

__all__ = ["ArtifactScorer", "load_artifact_scorer", "detect_engine"]

Source = Union[str, bytes]

# engine -> ((ndim, dtype kind) per positional arg); each is unique
_SIGNATURES: Dict[str, Tuple[Tuple[int, str], ...]] = {
    "visual": ((5, "u"), (1, "i")),
    "audio": ((2, "f"), (1, "i")),
    "au_patch": ((6, "u"), (3, "f"), (1, "i")),
    "au_face": ((5, "u"), (6, "u"), (3, "f"), (3, "f")),
    "av": ((5, "u"), (1, "i"), (2, "f"), (1, "i")),
}


def _kind(dtype: torch.dtype) -> str:
    if dtype == torch.uint8:
        return "u"
    return "f" if dtype.is_floating_point else "i"


def _input_values(program: torch.export.ExportedProgram) -> list:
    """The fake tensors of a program's user inputs, in order."""
    from torch.export.graph_signature import InputKind

    nodes = {n.name: n for n in program.graph.nodes if n.op == "placeholder"}
    return [nodes[s.arg.name].meta["val"] for s in program.graph_signature.input_specs
            if s.kind == InputKind.USER_INPUT]


def detect_engine(program: torch.export.ExportedProgram) -> str:
    """The serving engine an exported program scores for, from its inputs."""
    sig = tuple((v.ndim, _kind(v.dtype)) for v in _input_values(program))
    for name, want in _SIGNATURES.items():
        if sig == want:
            return name
    raise ValueError(f"not a recognized scoring artifact: input signature {sig} matches no "
                     "engine (see models/export.py for the exported calling conventions)")


def _static(dim) -> Optional[int]:
    """An int dim stays; a symbolic dim (the batch) becomes None."""
    return int(dim) if isinstance(dim, int) else None


def _pad_time(a: np.ndarray, T: int) -> np.ndarray:
    """Zero-pad or cut axis 1 to exactly ``T`` (the live engines' rule)."""
    if a.shape[1] > T:
        return a[:, :T]
    if a.shape[1] < T:
        pad = np.zeros((a.shape[0], T - a.shape[1]) + a.shape[2:], a.dtype)
        return np.concatenate([a, pad], axis=1)
    return a


class _Program:
    """One loaded artifact: its callable module, bucket key, fixed dims,
    device and precision."""

    def __init__(self, program: torch.export.ExportedProgram, engine: str,
                 manifest: Optional[dict]):
        self.engine = engine
        self.program = program
        self.call = program.module()
        shapes = [tuple(v.shape) for v in _input_values(program)]
        self.batch = _static(shapes[0][0])  # None = symbolic (any B)
        self.device = program_device(program)
        dtypes = (manifest or {}).get("compute_dtype", [])
        self.fp32 = "float32" in ([dtypes] if isinstance(dtypes, str) else dtypes)
        s0 = shapes[0]
        if engine == "visual":
            self.key: Tuple[int, ...] = (int(s0[1]),)  # (T,)
            self.fixed = ("HW", (int(s0[2]), int(s0[3])))
        elif engine == "audio":
            self.key = (int(s0[1]),)  # (S,)
            self.fixed = ("", ())
        elif engine == "au_patch":
            self.key = (int(s0[1]),)  # (T,)
            self.fixed = ("Ahw", tuple(int(d) for d in s0[2:5]))
        elif engine == "au_face":
            s1 = shapes[1]
            self.key = (int(s0[1]), int(s1[1]))  # (T, Ta): exact match
            self.fixed = ("HW+Ahw", (int(s0[2]), int(s0[3])) + tuple(int(d) for d in s1[2:5]))
        else:  # av
            self.key = (int(s0[1]), int(shapes[2][1]))  # (T, S)
            self.fixed = ("HW", (int(s0[2]), int(s0[3])))


class ArtifactScorer:
    """Score with exported programs through the live engines' ``score()`` API.

    ``sources``: artifact blobs (bytes) and/or paths, each a ``.ptprog``
    file or a directory of them; every artifact must target the same engine
    and device and agree on the non-length static dims (H/W, patch A/h/w):
    one artifact per serving bucket. ``device``: where the programs serve
    (default: where they were exported); another device type raises.

    ``hop_length`` (audio and av) turns sample counts into MFCC frame counts
    (``1 + samples // hop``) when the caller passes ``sample_lengths``
    instead of ``frame_lengths``; by default it is the manifests'. The
    artifact bakes the device-centred MFCC path, so a row shorter than its
    sample bucket is framed zero-padded with its tail frames masked: equal
    to the live engine for full-length rows, while the live engine's host
    re-centring of each row (``AudioScorer.score``) stays the exact path for
    batches of mixed durations.
    """

    def __init__(self, sources: Union[Source, Sequence[Source]], *,
                 engine: Optional[str] = None, hop_length: Optional[int] = None, device=None):
        blobs = _gather(sources)
        if not blobs:
            raise ValueError("no artifacts given")
        progs, manifest_hops = [], set()
        for blob in blobs:
            program = load_exported(blob, device)
            manifest = read_manifest(blob)
            detected = detect_engine(program)
            if manifest is not None:
                if manifest["engine"] != detected:
                    raise ValueError(f"corrupt artifact: manifest says {manifest['engine']!r} but "
                                     f"the program's input signature is a {detected!r} convention")
                if "hop_length" in manifest:
                    manifest_hops.add(int(manifest["hop_length"]))
            progs.append(_Program(program, detected, manifest))
        engines = {p.engine for p in progs}
        if len(engines) > 1:
            raise ValueError(f"artifacts target different engines: {sorted(engines)}")
        self.engine = progs[0].engine
        if engine is not None and engine != self.engine:
            raise ValueError(f"expected a {engine!r} artifact, got {self.engine!r}")
        devices = {p.device for p in progs}
        if len(devices) > 1:
            raise ValueError(f"artifacts were exported on different devices: {sorted(devices)}")
        self.device = torch.device(device if device is not None else devices.pop())
        fixed = {p.fixed for p in progs}
        if len(fixed) > 1:
            raise ValueError(f"artifacts disagree on fixed dims: {sorted(fixed)}")
        keys = [p.key for p in progs]
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate bucket keys among artifacts: {sorted(keys)}")
        self._programs = {p.key: p for p in progs}
        self.buckets: List[Tuple[int, ...]] = sorted(self._programs)
        if hop_length is None:
            if len(manifest_hops) > 1:
                raise ValueError(f"artifacts disagree on hop_length: {sorted(manifest_hops)}")
            hop_length = manifest_hops.pop() if manifest_hops else 160
        self.hop_length = int(hop_length)

    @property
    def programs(self) -> dict:
        """Bucket key -> the loaded ``torch.export.ExportedProgram``."""
        return {key: p.program for key, p in self._programs.items()}

    # -- dispatch -------------------------------------------------------------
    def _pick1(self, t: int) -> _Program:
        """Smallest single-axis bucket >= t; the largest if none covers."""
        return self._programs[(bucket_length(t, [k[0] for k in self.buckets]),)]

    @torch.inference_mode()
    def _run(self, prog: _Program, *args: np.ndarray) -> np.ndarray:
        """Pad a static batch (rows up, sliced back), then call on the device."""
        B = args[0].shape[0]
        if prog.batch is not None:
            if B > prog.batch:
                raise ValueError(f"batch {B} exceeds the artifact's static batch {prog.batch}")
            if B < prog.batch:
                args = tuple(np.concatenate([a, np.zeros((prog.batch - B,) + a.shape[1:], a.dtype)])
                             for a in args)
        tensors = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in args]
        with ieee_fp32() if prog.fp32 else contextlib.nullcontext():
            out = prog.call(*tensors)
        return out.cpu().numpy()[:B]

    # -- the live engines' score() signatures ----------------------------------
    def score(self, *args, **kw) -> np.ndarray:
        return getattr(self, f"_score_{self.engine}")(*args, **kw)

    def _score_visual(self, frames_u8, lengths=None):
        """As ``VisualScorer.score``."""
        frames_u8 = np.asarray(frames_u8)
        B, T = frames_u8.shape[:2]
        lengths = np.full((B,), T, np.int32) if lengths is None else np.asarray(lengths, np.int32)
        prog = self._pick1(T)
        return self._run(prog, _pad_time(frames_u8, prog.key[0]), np.minimum(lengths, prog.key[0]))

    def _frame_lengths(self, B: int, L: int, S: int, sample_lengths) -> np.ndarray:
        true = np.minimum(np.full((B,), L) if sample_lengths is None
                          else np.asarray(sample_lengths), S)
        return (1 + true // self.hop_length).astype(np.int32)

    def _score_audio(self, waveforms, frame_lengths=None, sample_lengths=None):
        """As ``AudioScorer.score``; see the class docstring's audio note."""
        waveforms = np.asarray(waveforms, np.float32)
        B, L = waveforms.shape
        S = self._pick1(L).key[0]
        waveforms = _pad_time(waveforms, S)
        if frame_lengths is None:
            frame_lengths = self._frame_lengths(B, L, S, sample_lengths)
        return self._run(self._pick1(L), waveforms, np.asarray(frame_lengths, np.int32))

    def _score_au_patch(self, patches_u8, au_weights=None, lengths=None):
        """As ``AUPatchScorer.score``."""
        patches_u8 = np.asarray(patches_u8)
        B, T, A = patches_u8.shape[:3]
        want = self._programs[self.buckets[0]].fixed[1]
        if patches_u8.shape[2:5] != want:
            raise ValueError(f"patch dims {patches_u8.shape[2:5]} != the artifact's {want}")
        if au_weights is None:
            au_weights = np.ones((B, T, A), np.float32)
        if lengths is None:
            lengths = np.full((B,), T, np.int32)
        prog = self._pick1(T)
        Tb = prog.key[0]
        return self._run(prog, _pad_time(patches_u8, Tb),
                         _pad_time(np.asarray(au_weights, np.float32), Tb),
                         np.minimum(np.asarray(lengths, np.int32), Tb))

    def _score_au_face(self, videos_u8, au_patches_u8, au_mask=None, au_weight=None):
        """As ``AUFaceScorer.score``, at an exact ``(T, Ta)`` only: the
        artifact bakes its valid lengths (``export_au_face``)."""
        videos_u8, au_patches_u8 = np.asarray(videos_u8), np.asarray(au_patches_u8)
        B, T = videos_u8.shape[:2]
        Ta, A = au_patches_u8.shape[1:3]
        prog = self._programs.get((T, Ta))
        if prog is None:
            raise ValueError(f"no artifact for (T={T}, Ta={Ta}); au_face artifacts bake "
                             f"their valid lengths: have {self.buckets}")
        ones = np.ones((B, Ta, A), np.float32)
        return self._run(prog, videos_u8, au_patches_u8,
                         ones if au_mask is None else np.asarray(au_mask, np.float32),
                         ones if au_weight is None else np.asarray(au_weight, np.float32))

    def _score_av(self, frames_u8, waveforms, lengths=None, frame_lengths=None,
                  sample_lengths=None):
        """As ``AVScorer.score``. Buckets on (T, S): the smallest covering T,
        then the smallest covering S among that T's artifacts."""
        frames_u8, waveforms = np.asarray(frames_u8), np.asarray(waveforms, np.float32)
        if frames_u8.shape[0] != waveforms.shape[0]:
            raise ValueError(f"paired modalities must share B: {frames_u8.shape[0]} vs "
                             f"{waveforms.shape[0]}")
        B, T = frames_u8.shape[:2]
        L = waveforms.shape[1]
        Tb = bucket_length(T, sorted({k[0] for k in self.buckets}))
        Sb = bucket_length(L, sorted(k[1] for k in self.buckets if k[0] == Tb))
        lengths = np.full((B,), T, np.int32) if lengths is None else np.asarray(lengths, np.int32)
        if frame_lengths is None:
            frame_lengths = self._frame_lengths(B, L, Sb, sample_lengths)
        return self._run(self._programs[(Tb, Sb)], _pad_time(frames_u8, Tb),
                         np.minimum(lengths, Tb), _pad_time(waveforms, Sb),
                         np.asarray(frame_lengths, np.int32))


def _gather(sources: Union[Source, Sequence[Source]]) -> List[bytes]:
    """Paths, directories and blobs -> artifact byte strings."""
    if isinstance(sources, (str, bytes)):
        sources = [sources]
    blobs: List[bytes] = []
    for src in sources:
        if isinstance(src, bytes):
            blobs.append(src)
        elif os.path.isdir(src):
            names = sorted(n for n in os.listdir(src) if n.endswith(SUFFIX))
            if not names:
                raise FileNotFoundError(f"no {SUFFIX} artifacts under {src}")
            for n in names:
                with open(os.path.join(src, n), "rb") as f:
                    blobs.append(f.read())
        else:
            with open(src, "rb") as f:
                blobs.append(f.read())
    return blobs


def load_artifact_scorer(sources: Union[Source, Sequence[Source]], *,
                         engine: Optional[str] = None, hop_length: Optional[int] = None,
                         device=None) -> ArtifactScorer:
    """An :class:`ArtifactScorer` from paths, directories or blobs."""
    return ArtifactScorer(sources, engine=engine, hop_length=hop_length, device=device)
