"""Serving engines: uint8 clips, raw waveforms or AU patch stacks -> fake
probabilities.

Counterpart of ``multimodal_deepfake_detection_tpu/models/serve.py``'s
``VisualScorer``, ``AudioScorer``, ``AVScorer``, ``AUFaceScorer`` and
``AUPatchScorer``. The two Xception engines share
the backbone (:class:`_XceptionScorer`): the BN-folded Xception in the
compute dtype, the 8 middle-flow blocks through the K1 kernel when the
tensors are on CUDA (with ``middle_taps="bf16"`` in bf16 tap order), with
``fuse_entry`` the 4 stride-2 blocks through the K3 kernel or with
``entry_pair`` their separable pairs through K4, and with ``fuse_exit`` the
exit sepconvs through K5 (``models/fold.py``); or, with ``quantize``, the
w8a8 tree (``models/quant.py``).

- :meth:`VisualScorer.score`: uint8 ``(B, T, H, W, 3)`` -> fp32 / 255,
  optional bilinear resize; the backbone over the B*T frames; the LSTM over
  T in the compute dtype, last valid step; ArcFace cosine logits (s=30) in
  fp32, softmax fake probability.
- :meth:`AudioScorer.score`: waveforms ``(B, L)`` -> MFCC ``(B, T, 13)`` in
  IEEE fp32 (``ops/mfcc.py``), each 10 ms column a 13 x 1 image tripled to 3
  channels and resized bilinearly to 64^2; the backbone over the B*T images;
  the LSTM, last valid step and MLP head in the compute dtype, sigmoid in
  fp32.
- :meth:`AVScorer.score`: ``alpha * p_visual + (1 - alpha) * p_audio``.
- :meth:`AUFaceScorer.score` and :meth:`AUPatchScorer.score`: uint8 inputs
  -> fp32 / 255, optional bilinear resize; the AU models
  (``models/au_face.py``, ``models/resnet_lstm.py``) with their ResNet-18s
  in eval BN on cuDNN, or with ``quantize="w8a8"`` the int8 ResNet-18 trees
  (``models/quant.py``); ``sigmoid(logits[:, 0])`` in fp32. No kernel of
  the port's own runs on these paths: the JAX package runs none of its
  Pallas kernels there either.

Clips are padded (or cut) to a length bucket as the JAX engines do, so the
scores match them; the JAX jit cache has no counterpart. Each engine's
``score()`` prepares its inputs on the host (numpy: buckets, padding,
default lengths) and calls its ``_score_impl`` on device tensors, the
counterpart of the JAX ``_score_impl``: the function ``models/export.py``
exports, so an artifact replays the live path's own ops.

``mesh=`` (a list of devices, ``parallel/mesh.py``) shards each engine's
batches, as the JAX engines' data mesh does: every device holds a replica
of the weights (the fold, the quantized tree once calibrated, the heads),
the batch is padded with ``lengths == 0`` rows to a multiple of the mesh
size and split into contiguous blocks, every block is enqueued on its
device before any result is read, and the scores come back in order with
the pad rows dropped. ``device`` is then the mesh's first device, where
``calibrate`` runs once for all replicas. Without ``mesh`` the engine is
the one replica of its ``device`` and scores each batch as one block
(``parallel/mesh.py::map_shards``).

The quantization modes are the JAX engines': ``"w8a8"`` (every conv and
depthwise int8), ``"w8a8-hybrid"`` (int8 entry and exit, the fp middle flow
through K1) and ``"w8a8-pallas"`` (int8 throughout, the middle flow through
K2). The first ``score`` calibrates on its batch unless ``calibrate`` ran
before; ``calibrate(refine_passes=n)`` adds the affine refinement
(``models/quant.py::refine_quantized_xception``).

``compute_dtype=torch.float32`` means IEEE fp32 on the card: every forward
of the scorer runs with TF32 switched off in cuDNN and cuBLAS (torch's
default lets cuDNN round fp32 convolution inputs to TF32's 10-bit mantissa),
and the setting is restored when the call returns or raises.
"""
from __future__ import annotations

import copy
import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.checkpoint import load_bundle, merge_params
from ..core.precision import ieee_fp32
from ..data.collate import bucket_length
from ..ops.lstm import lstm_apply, select_last_step
from ..ops.mfcc import mfcc, mfcc_constants
from ..ops.resize import resize_bilinear
from ..parallel.mesh import map_shards, replicas, to_device
from ..utils.jax_weights import (
    arcface_from_jax,
    arcface_to_jax,
    au_face_from_jax,
    au_face_to_jax,
    au_patch_from_jax,
    au_patch_to_jax,
    xception_lstm_from_jax,
    xception_lstm_to_jax,
)
from .au_face import AUFaceDetector, au_face_detector_apply, masked_mean
from .fold import check_routes, fold_resnet18_bn, fold_xception_bn
from .heads import ArcFace, XceptionLSTM, arcface_apply, xception_lstm_head_apply
from .quant import (
    QuantizedResNet18,
    QuantizedXception,
    calibrate_amax,
    calibrate_resnet18_amax,
    quantize_folded_resnet18,
    quantize_folded_xception,
    refine_quantized_resnet18,
    refine_quantized_xception,
    resnet18_quant_walk,
    xception_quant_walk,
)
from .resnet_lstm import AUPatchClassifier, au_patch_classifier_apply
from .xception import Xception

QUANT_MODES = (None, "w8a8", "w8a8-hybrid", "w8a8-pallas")
AU_QUANT_MODES = (None, "w8a8")
AUDIO_IMAGE = (64, 64)  # each MFCC column becomes one image of this size


def _ieee_fp32(method):
    """Runs a scorer's forward in IEEE fp32 (:func:`ieee_fp32`) when it
    computes in fp32; bf16 scoring leaves the settings alone."""
    @functools.wraps(method)
    def run(self, *args, **kw):
        if self.compute_dtype != torch.float32:
            return method(self, *args, **kw)
        with ieee_fp32():
            return method(self, *args, **kw)
    return run


def merge_xception_lstm(bundle: dict, hidden_dim: int, g: torch.Generator, *,
                        strict: bool = True) -> XceptionLSTM:
    """``model`` merged onto a freshly initialised XceptionLSTM tree of the
    same shapes, strictly by default, so no initial value survives (with
    ``strict=False`` missing weights keep the port's init from ``g``);
    ``state`` leniently (missing BN statistics keep their init, mean 0 and
    var 1), as the JAX loaders do."""
    params, state = xception_lstm_to_jax(XceptionLSTM(hidden_dim, generator=g))
    params = merge_params(params, bundle["model"], strict=strict)
    if "state" in bundle:
        state = merge_params(state, bundle["state"], strict=False)
    return xception_lstm_from_jax(params, state)


def load_visual_bundle(path: str, hidden_dim: int = 128, *, strict: bool = True,
                       seed: int = 0) -> Tuple[XceptionLSTM, ArcFace]:
    """Read a JAX ``train_visual`` bundle ``{model, arcface[, state]}``;
    ``arcface`` merges as ``model`` does (:func:`merge_xception_lstm`, the
    initial trees drawn from ``seed``)."""
    g = torch.Generator().manual_seed(seed)
    bundle = load_bundle(path)
    model = merge_xception_lstm(bundle, hidden_dim, g, strict=strict)
    arc = merge_params(arcface_to_jax(ArcFace(hidden_dim, 2, generator=g)), bundle["arcface"],
                       strict=strict)
    return model, arcface_from_jax(arc)


def load_audio_bundle(path: str, hidden_dim: int = 512) -> XceptionLSTM:
    """Read a JAX ``train_audio`` bundle ``{model[, state]}``."""
    return merge_xception_lstm(load_bundle(path), hidden_dim, torch.Generator().manual_seed(0))


def mfcc_images(feats: torch.Tensor) -> torch.Tensor:
    """MFCC ``(B, T, n)`` -> ``(B*T, 64, 64, 3)``: each column an ``n x 1``
    image, tripled to 3 channels and resized bilinearly. The images come
    back NHWC-contiguous, as the visual engine's frames do: the resize
    returns them channels-first in memory, and the convs on the plain
    blocks would run in that layout (on the card, ATen's own depthwise and
    max pool in NCHW instead of cuDNN's channels-last kernels)."""
    B, T, n = feats.shape
    imgs = feats.reshape(B * T, n, 1, 1).expand(B * T, n, 1, 3)
    return resize_bilinear(imgs, AUDIO_IMAGE).contiguous()


def _to_device(a, device) -> Optional[torch.Tensor]:
    return None if a is None else to_device(a, device)


class _ShardedScoringMixin:
    """Batch scoring over a device list (``mesh``; one device without it),
    shared by the engines.

    ``_replica_attrs`` names the device-bound attributes each further device
    gets a copy of; the engine itself serves the first device. The replicas
    are built at the first call after construction or calibration, so all
    share one calibrated tree."""

    _replica_attrs: Tuple[str, ...] = ()

    def _init_mesh(self, mesh, device) -> torch.device:
        """-> the engine's primary device: the mesh's first, else ``device``."""
        self.mesh = [torch.device(d) for d in (mesh or [device])]
        self._replica_cache = None
        return self.mesh[0]

    def _replicas(self) -> list:
        if self._replica_cache is None:
            self._replica_cache = replicas(self, self.mesh, self._replica_attrs)
        return self._replica_cache

    def _score_rows(self, arrays: tuple, *static) -> np.ndarray:
        """``_score_impl`` over host ``arrays`` (batch on axis 0; None passes
        through) and the ``static`` arguments -> fp32 probabilities ``(B,)``."""
        return map_shards(self._replicas(), lambda r, *blocks: r._score_impl(*blocks, *static),
                          arrays).numpy()


class _XceptionScorer(_ShardedScoringMixin):
    """The backbone both engines serve: the fp fold in the compute dtype with
    its kernel routes, or a quant mode's w8a8 tree, calibrated (and refined)
    from the fp32 fold."""

    def __init__(self, backbone: Xception, *, compute_dtype: torch.dtype,
                 use_kernels: Optional[bool], quantize: Optional[str], fuse_entry: bool,
                 entry_pair: bool, middle_taps: str, fuse_exit: bool, device, mesh=None):
        """``use_kernels=None`` runs the middle flow through the K1 kernel
        (K2 under ``quantize="w8a8-pallas"``) and the int8 depthwise through
        its kernel exactly when ``device`` is CUDA; ``False`` runs the plain
        versions (the reference runs compare against this). ``quantize``:
        one of :data:`QUANT_MODES`. When kernels run, the fp path's routes
        (``models/fold.py``): ``fuse_entry`` runs the 4 stride-2 blocks
        through the K3 kernel, ``entry_pair`` their separable pairs through
        K4 (not both); ``middle_taps="bf16"`` runs K1 in bf16 tap order;
        ``fuse_exit`` runs conv3 and conv4 through K5. The w8a8 walk has none
        of these routes, so each raises together with ``quantize``."""
        if quantize not in QUANT_MODES:
            raise ValueError(
                f"quantize must be None, 'w8a8', 'w8a8-hybrid' or 'w8a8-pallas', got {quantize!r}"
            )
        check_routes(fuse_entry=fuse_entry, entry_pair=entry_pair, middle_taps=middle_taps)
        routes = dict(fuse_entry=fuse_entry, entry_pair=entry_pair,
                      middle_taps=middle_taps != "fp32", fuse_exit=fuse_exit)
        for name, on in routes.items():
            if on and quantize:
                raise ValueError(f"{name} is a route of the fp path's kernels; "
                                 f"quantize={quantize!r} has no such route")
        self.device = self._init_mesh(mesh, device)
        self.compute_dtype = compute_dtype
        self.use_kernels = self.device.type == "cuda" if use_kernels is None else use_kernels
        self.quantize = quantize
        self.routes = dict(fuse_entry=fuse_entry, entry_pair=entry_pair, middle_taps=middle_taps,
                           fuse_exit=fuse_exit)
        # the fp path's weights, stored in the compute dtype; a quantized
        # scorer serves the w8a8 tree instead and folds only at fp32: the
        # quantizer reads fp32 folded weights (quantizing the compute-dtype
        # fold would round every weight twice)
        self.folded_backbone = (
            None if quantize else fold_xception_bn(backbone, compute_dtype).to(self.device)
        )
        self.fp_tree = (
            QuantizedXception.from_folded(fold_xception_bn(backbone, torch.float32))
            .to(self.device) if quantize else None
        )
        self.qbackbone: Optional[QuantizedXception] = None  # set by calibrate()

    def _calibrate_on(self, x: torch.Tensor, refine_passes: int) -> None:
        """Fit the activation scales on the images ``x`` (the depthwise convs
        quantized too; ``"w8a8-hybrid"`` leaves the middle flow fp), refine
        ``refine_passes`` times, and serve the tree.

        The refinement fits in IEEE fp32 whatever the compute dtype (the JAX
        scorers fit in theirs): in bf16 both sides of each per-channel fit
        carry bf16 rounding, which pulls its gain toward 0, and the refined
        visual scorer moved away from plain fp32 (ROADMAP Queue 3, F3)."""
        amaxes = calibrate_amax(self.fp_tree, x, compute_dtype=self.compute_dtype)
        qtree = quantize_folded_xception(
            self.fp_tree, amaxes, quant_depthwise=True,
            skip_middle=self.quantize == "w8a8-hybrid",
        )
        if refine_passes:
            with ieee_fp32():
                qtree = refine_quantized_xception(qtree, self.fp_tree, x, passes=refine_passes,
                                                  compute_dtype=torch.float32)
        self.qbackbone = qtree
        self._replica_cache = None

    def _backbone_features(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC images -> per-image features ``(N, 2048)`` in the compute dtype."""
        if self.qbackbone is not None:
            return xception_quant_walk(
                self.qbackbone, x, quant=True, compute_dtype=self.compute_dtype,
                features_only=True, fuse_middle=self.quantize != "w8a8",
                use_kernels=self.use_kernels,
            )
        return self.folded_backbone(x, features_only=True, use_kernels=self.use_kernels,
                                    **self.routes)


class VisualScorer(_XceptionScorer):
    """XceptionLSTMV + ArcFace scoring on raw uint8 frame stacks."""

    _replica_attrs = ("folded_backbone", "qbackbone", "lstm", "arcface_w")

    @classmethod
    def from_bundle(cls, path: str, hidden_dim: int = 128, **kw) -> "VisualScorer":
        """Build from a ``train_visual`` ``{model, arcface[, state]}`` bundle."""
        return cls(*load_visual_bundle(path, hidden_dim), **kw)

    def __init__(
        self,
        model: XceptionLSTM,
        arcface: ArcFace,
        *,
        arcface_s: float = 30.0,
        frame_size: Optional[Tuple[int, int]] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        use_kernels: Optional[bool] = None,
        mask_padding: bool = True,
        buckets: Optional[Sequence[int]] = None,
        quantize: Optional[str] = None,
        fuse_entry: bool = False,
        entry_pair: bool = False,
        middle_taps: str = "fp32",
        fuse_exit: bool = False,
        device="cuda",
        mesh=None,
    ):
        """Backbone options: :class:`_XceptionScorer`. ``buckets``: T pads up
        to a bucket, as in the JAX engine. ``mesh``: a device list the
        batches shard over (module docstring)."""
        super().__init__(model.backbone, compute_dtype=compute_dtype, use_kernels=use_kernels,
                         quantize=quantize, fuse_entry=fuse_entry, entry_pair=entry_pair,
                         middle_taps=middle_taps, fuse_exit=fuse_exit, device=device, mesh=mesh)
        self.lstm = copy.deepcopy(model.lstm).to(self.device)
        self.arcface_w = arcface.w.detach().to(self.device, torch.float32)
        self.arcface_s = arcface_s
        self.frame_size = frame_size
        self.mask_padding = mask_padding
        self.buckets = tuple(buckets) if buckets else None

    def _u8_to_x(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """uint8 ``(B, T, H, W, 3)`` on the device -> fp32 / 255 frames ``(B*T,
        H, W, 3)``, resized bilinearly to ``frame_size`` when it differs."""
        B, T = frames_u8.shape[:2]
        x = frames_u8.reshape((B * T,) + tuple(frames_u8.shape[2:])).float() / 255.0
        if self.frame_size is not None and tuple(x.shape[1:3]) != tuple(self.frame_size):
            x = resize_bilinear(x, self.frame_size)
        return x

    def _frames_to_x(self, frames_u8: np.ndarray) -> torch.Tensor:
        return self._u8_to_x(torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device))

    @_ieee_fp32
    def calibrate(self, frames_u8: np.ndarray, *, refine_passes: int = 0) -> None:
        """Fit the w8a8 activation scales on a representative uint8 frame
        batch ``(B, T, H, W, 3)`` and switch the backbone to the quantized
        tree (no-op when ``quantize=None``). ``refine_passes > 0`` adds the
        affine refinement on the same frames."""
        if self.quantize is None:
            return
        self._calibrate_on(self._frames_to_x(np.asarray(frames_u8)), refine_passes)

    @_ieee_fp32
    @torch.inference_mode()
    def frame_features(self, frames_u8: np.ndarray) -> torch.Tensor:
        """``(B, T, H, W, 3)`` uint8 -> per-frame features ``(B, T, 2048)`` in
        the compute dtype, on the scorer's device. A quantized scorer not yet
        calibrated calibrates on this batch first, as :meth:`score` does."""
        if self.quantize is not None and self.qbackbone is None:
            self.calibrate(frames_u8)
        B, T = frames_u8.shape[:2]
        return self._backbone_features(self._frames_to_x(frames_u8)).reshape(B, T, -1)

    def _score_impl(self, frames_u8: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """The device side of :meth:`score`: uint8 ``(B, T, H, W, 3)`` and
        integer ``lengths (B,)`` on the scorer's device -> fp32 fake
        probabilities ``(B,)``; the program ``models/export.py::export_visual``
        traces."""
        B, T = frames_u8.shape[:2]
        feats = self._backbone_features(self._u8_to_x(frames_u8)).reshape(B, T, -1)
        outputs, _ = lstm_apply(self.lstm, feats, compute_dtype=self.compute_dtype)
        emb = select_last_step(outputs, lengths.long(), mask_padding=self.mask_padding)
        logits = arcface_apply(self.arcface_w, emb, s=self.arcface_s)
        return torch.softmax(logits, dim=-1)[:, 1]

    @_ieee_fp32
    @torch.inference_mode()
    def score(self, frames_u8: np.ndarray, lengths: Optional[np.ndarray] = None) -> np.ndarray:
        """``(B, T, H, W, 3)`` uint8 -> fake probabilities ``(B,)``."""
        if self.quantize is not None and self.qbackbone is None:
            self.calibrate(frames_u8)  # implicit first-batch calibration
        B, T = frames_u8.shape[:2]
        if lengths is None:
            lengths = np.full((B,), T, np.int32)
        if self.buckets:
            Tb = bucket_length(T, self.buckets)
            if Tb > T:
                pad = np.zeros((B, Tb - T) + frames_u8.shape[2:], frames_u8.dtype)
                frames_u8 = np.concatenate([frames_u8, pad], axis=1)
            elif Tb < T:  # longer than the largest bucket: truncate
                frames_u8 = frames_u8[:, :Tb]
                lengths = np.minimum(lengths, Tb)
        return self._score_rows((frames_u8, np.asarray(lengths)))


class AudioScorer(_XceptionScorer):
    """XceptionLSTMA scoring straight from raw 16 kHz waveforms."""

    _replica_attrs = ("folded_backbone", "qbackbone", "head", "mfcc_constants")

    @classmethod
    def from_bundle(cls, path: str, hidden_dim: int = 512, **kw) -> "AudioScorer":
        """Build from a ``train_audio`` ``{model[, state]}`` bundle."""
        return cls(load_audio_bundle(path, hidden_dim), **kw)

    def __init__(
        self,
        model: XceptionLSTM,
        *,
        sr: int = 16000,
        n_mfcc: int = 13,
        n_fft: int = 400,
        hop_length: int = 160,
        compute_dtype: torch.dtype = torch.bfloat16,
        use_kernels: Optional[bool] = None,
        mask_padding: bool = True,
        sample_buckets: Optional[Sequence[int]] = None,
        quantize: Optional[str] = None,
        fuse_entry: bool = False,
        entry_pair: bool = False,
        middle_taps: str = "fp32",
        fuse_exit: bool = False,
        device="cuda",
        mesh=None,
    ):
        """Backbone options: :class:`_XceptionScorer`; ``mesh``: as
        :class:`VisualScorer`'s. ``sample_buckets``:
        the sample axis pads up to a bucket. The true signal is then
        reflect-centred on the host and framed uncentred on the device, so
        every frame of the true length is the one the unbucketed engine
        computes, and the frames past it are masked."""
        super().__init__(model.backbone, compute_dtype=compute_dtype, use_kernels=use_kernels,
                         quantize=quantize, fuse_entry=fuse_entry, entry_pair=entry_pair,
                         middle_taps=middle_taps, fuse_exit=fuse_exit, device=device, mesh=mesh)
        self.head = copy.deepcopy(nn.ModuleDict(dict(
            lstm=model.lstm, fc_layers=model.fc_layers, fc_out=model.fc_out))).to(self.device)
        self.mfcc_kw = dict(sr=sr, n_mfcc=n_mfcc, n_fft=n_fft, hop_length=hop_length)
        self.mfcc_constants = mfcc_constants(self.device, sr=sr, n_mfcc=n_mfcc, n_fft=n_fft)
        self.mask_padding = mask_padding
        self.sample_buckets = tuple(sorted(sample_buckets)) if sample_buckets else None

    def _images(self, waveforms: torch.Tensor, centered: bool) -> Tuple[torch.Tensor, int, int]:
        """``(B, L)`` fp32 waveforms on the device -> MFCC images ``(B*T, 64,
        64, 3)`` fp32, ``B``, ``T``."""
        feats = mfcc(waveforms, center=centered, constants=self.mfcc_constants, **self.mfcc_kw)
        return mfcc_images(feats), feats.shape[0], feats.shape[1]

    def _wave_to_imgs(self, waveforms: np.ndarray, centered: bool) -> Tuple[torch.Tensor, int, int]:
        """``(B, L)`` waveforms -> MFCC images ``(B*T, 64, 64, 3)`` fp32 on the
        device, ``B``, ``T``."""
        w = torch.from_numpy(np.ascontiguousarray(waveforms, np.float32)).to(self.device)
        return self._images(w, centered)

    def _prepare(self, waveforms: np.ndarray, frame_lengths: Optional[np.ndarray],
                 sample_lengths: Optional[np.ndarray]):
        """The host side of :meth:`score`: -> (waveforms, frame lengths,
        whether the device centres them)."""
        B, L = waveforms.shape[:2]
        n_fft, hop = self.mfcc_kw["n_fft"], self.mfcc_kw["hop_length"]
        half = n_fft // 2
        if sample_lengths is not None:
            # mixed lengths: each row centred on its own true length, then a
            # shared zero-padded sample axis framed uncentred on the device
            sample_lengths = np.asarray(sample_lengths, np.int64)
            if sample_lengths.shape != (B,):
                raise ValueError(f"sample_lengths must be ({B},), got {sample_lengths.shape}")
            Lb = bucket_length(L, self.sample_buckets) if self.sample_buckets else L
            if Lb < L:  # longer than the largest bucket: truncate
                waveforms, L = waveforms[:, :Lb], Lb
                sample_lengths = np.minimum(sample_lengths, Lb)
            if np.any(sample_lengths <= half):
                raise ValueError(f"every sample_length must exceed n_fft//2 = {half} "
                                 "for reflect centring (librosa's constraint)")
            centered = np.zeros((B, Lb + 2 * half), np.float32)
            wf = np.asarray(waveforms, np.float32)
            for i, Li in enumerate(sample_lengths):
                centered[i, : Li + 2 * half] = np.pad(wf[i, :Li], (half, half), mode="reflect")
            n_valid = (1 + sample_lengths // hop).astype(np.int32)
            frame_lengths = n_valid if frame_lengths is None else np.minimum(frame_lengths, n_valid)
            return centered, frame_lengths, False
        if self.sample_buckets:
            Lb = bucket_length(L, self.sample_buckets)
            if Lb < L:  # longer than the largest bucket: truncate
                waveforms, L = waveforms[:, :Lb], Lb
            # librosa's centring here, on the true length; then the zero pad
            waveforms = np.pad(np.asarray(waveforms, np.float32), ((0, 0), (half, half)),
                               mode="reflect")
            waveforms = np.pad(waveforms, ((0, 0), (0, Lb - L)))
            valid = np.full((B,), 1 + L // hop, np.int32)  # frames of the true signal
            frame_lengths = valid if frame_lengths is None else np.minimum(frame_lengths, valid)
            return waveforms, frame_lengths, False
        return waveforms, frame_lengths, True

    @_ieee_fp32
    def calibrate(self, waveforms: np.ndarray, *, refine_passes: int = 0) -> None:
        """Fit the w8a8 activation scales on the centred MFCC images of a
        representative waveform batch ``(B, L)`` and switch the backbone to
        the quantized tree (no-op when ``quantize=None``); ``refine_passes >
        0`` adds the affine refinement on the same images."""
        if self.quantize is None:
            return
        with torch.inference_mode():
            imgs, _, _ = self._wave_to_imgs(np.asarray(waveforms), centered=True)
        self._calibrate_on(imgs, refine_passes)

    @_ieee_fp32
    @torch.inference_mode()
    def frame_features(self, waveforms: np.ndarray,
                       sample_lengths: Optional[np.ndarray] = None) -> torch.Tensor:
        """``(B, L)`` waveforms -> per-frame features ``(B, T, 2048)`` in the
        compute dtype, on the scorer's device, through the branch
        :meth:`score` takes. A quantized scorer not yet calibrated calibrates
        on this batch first, as :meth:`score` does."""
        if self.quantize is not None and self.qbackbone is None:
            self.calibrate(waveforms)
        waveforms, _, centered = self._prepare(waveforms, None, sample_lengths)
        imgs, B, T = self._wave_to_imgs(waveforms, centered)
        return self._backbone_features(imgs).reshape(B, T, -1)

    @_ieee_fp32
    @torch.inference_mode()
    def score(self, waveforms: np.ndarray, frame_lengths: Optional[np.ndarray] = None,
              sample_lengths: Optional[np.ndarray] = None) -> np.ndarray:
        """``(B, L)`` float waveforms -> fake probabilities ``(B,)``.

        ``sample_lengths (B,)`` marks each row's true length in a batch of
        clips zero-padded to a common sample axis: each row is reflect-centred
        on the host on its own length and its frames past ``1 + len // hop``
        are masked, so each row scores as that clip alone does. Without it
        every row's true signal is the whole axis."""
        if self.quantize is not None and self.qbackbone is None:
            self.calibrate(waveforms)  # implicit first-batch calibration
        waveforms, frame_lengths, centered = self._prepare(waveforms, frame_lengths,
                                                           sample_lengths)
        lengths = None if frame_lengths is None else np.asarray(frame_lengths)
        return self._score_rows((np.asarray(waveforms, np.float32), lengths), centered)

    def _score_impl(self, waveforms: torch.Tensor, frame_lengths: Optional[torch.Tensor],
                    centered: bool) -> torch.Tensor:
        """The device side of :meth:`score`: fp32 waveforms ``(B, L)`` and
        integer ``frame_lengths (B,)`` (or None: every frame valid) on the
        scorer's device -> fp32 fake probabilities ``(B,)``; ``centered``:
        reflect-centre on the device. ``models/export.py::export_audio``
        traces it with ``centered=True``."""
        imgs, B, T = self._images(waveforms, centered)
        feats = self._backbone_features(imgs).reshape(B, T, -1)
        lengths = None if frame_lengths is None else frame_lengths.long()
        probs = xception_lstm_head_apply(self.head, feats, lengths=lengths,
                                         mask_padding=self.mask_padding,
                                         compute_dtype=self.compute_dtype)
        return probs[:, 0]


class AVScorer:
    """Audio-visual fusion over paired clips: ``alpha * p_visual + (1 - alpha)
    * p_audio``, the rule of the JAX package's batch AV evaluation. Each
    engine keeps its own buckets, quant mode and kernel routes."""

    def __init__(self, visual: VisualScorer, audio: AudioScorer, *, alpha: float = 0.5):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        self.visual = visual
        self.audio = audio
        self.alpha = float(alpha)

    @classmethod
    def from_bundles(cls, visual_path: str, audio_path: str, *, alpha: float = 0.5,
                     hidden_dim: int = 128, audio_hidden: int = 512, **kw) -> "AVScorer":
        """Both engines from their training bundles; ``**kw`` (``compute_dtype``,
        ``mask_padding``, ``quantize``, the routes, ``device``...) goes to both."""
        return cls(VisualScorer.from_bundle(visual_path, hidden_dim=hidden_dim, **kw),
                   AudioScorer.from_bundle(audio_path, hidden_dim=audio_hidden, **kw),
                   alpha=alpha)

    def score(self, frames_u8: np.ndarray, waveforms: np.ndarray,
              lengths: Optional[np.ndarray] = None, frame_lengths: Optional[np.ndarray] = None,
              sample_lengths: Optional[np.ndarray] = None) -> np.ndarray:
        """uint8 frames ``(B, T, H, W, 3)`` and float waveforms ``(B, L)`` of the
        same B clips -> fused fake probabilities ``(B,)``. ``sample_lengths``:
        as :meth:`AudioScorer.score`."""
        if frames_u8.shape[0] != waveforms.shape[0]:
            raise ValueError(
                f"paired modalities must share B: {frames_u8.shape[0]} vs {waveforms.shape[0]}"
            )
        p_v = self.visual.score(frames_u8, lengths)
        p_a = self.audio.score(waveforms, frame_lengths, sample_lengths=sample_lengths)
        return self._fuse(torch.from_numpy(p_v), torch.from_numpy(p_a)).numpy()

    def _fuse(self, p_v: torch.Tensor, p_a: torch.Tensor) -> torch.Tensor:
        return self.alpha * p_v + (1.0 - self.alpha) * p_a

    def _score_impl(self, frames_u8: torch.Tensor, lengths: torch.Tensor,
                    waveforms: torch.Tensor, frame_lengths: torch.Tensor) -> torch.Tensor:
        """Both engines' device sides and the fusion, the program
        ``models/export.py::export_av`` traces: the visual one's and the
        audio one's with ``centered=True``, each under its own precision."""
        return self._fuse(self.visual._score_impl(frames_u8, lengths),
                          self.audio._score_impl(waveforms, frame_lengths, True))


def load_au_face_bundle(path: str, lstm_hidden: int = 256, *, strict: bool = True,
                        seed: int = 0, log: Callable[[str], None] = lambda s: None
                        ) -> AUFaceDetector:
    """Read a JAX ``train_au_face`` bundle ``{model[, embed, arcface, state]}``
    or a bare model tree: ``model`` merges onto a fresh tree drawn from
    ``seed``, strictly unless ``strict=False``, and where that fails
    non-strictly (missing weights keep the port's seeded init), each step
    told to ``log`` in ``cli/test_au_face.py``'s ``[Load]`` lines; ``state``
    leniently. Other trees are ignored."""
    params, state = au_face_to_jax(AUFaceDetector(lstm_hidden,
                                                  generator=torch.Generator().manual_seed(seed)))
    bundle = load_bundle(path)
    tree = bundle.get("model", bundle)
    try:
        params = merge_params(params, tree, strict=strict)
        log(f"[Load] {path} ok (strict={strict})")
    except (KeyError, ValueError) as e:
        log(f"[Load] strict failed -> {type(e).__name__}: {e}")
        params = merge_params(params, tree, strict=False)
        log("[Load] non-strict fallback applied")
    if "state" in bundle:
        state = merge_params(state, bundle["state"], strict=False)
    return au_face_from_jax(params, state)


def load_au_patch_bundle(path: str, hidden_dim: int = 128, lstm_hidden: int = 128
                         ) -> AUPatchClassifier:
    """Read a JAX ``train_au_patch`` bundle ``{model[, state]}`` or a bare
    model tree: ``model`` strictly, ``state`` leniently."""
    params, state = au_patch_to_jax(AUPatchClassifier(
        hidden_dim, lstm_hidden, generator=torch.Generator().manual_seed(0)))
    bundle = load_bundle(path)
    params = merge_params(params, bundle.get("model", bundle), strict=True)
    if "state" in bundle:
        state = merge_params(state, bundle["state"], strict=False)
    return au_patch_from_jax(params, state)


def _prep_t(u8: torch.Tensor, size: Optional[Tuple[int, int]]) -> torch.Tensor:
    """uint8 ``(..., H, W, 3)`` on the device -> fp32 / 255, resized
    bilinearly to ``size`` when it differs."""
    x = u8.float() / 255.0
    if size is not None and tuple(x.shape[-3:-1]) != tuple(size):
        x = resize_bilinear(x, size)
    return x


def _prep(u8: np.ndarray, size: Optional[Tuple[int, int]], device) -> torch.Tensor:
    """uint8 ``(..., H, W, 3)`` -> fp32 / 255 on ``device``, resized
    bilinearly to ``size`` when it differs."""
    return _prep_t(torch.from_numpy(np.ascontiguousarray(u8)).to(device), size)


def _pad_time(arr: np.ndarray, Tb: int) -> np.ndarray:
    """Zero-pad (or cut) axis 1 to ``Tb``."""
    T = arr.shape[1]
    if Tb <= T:
        return arr[:, :Tb]
    pad = np.zeros((arr.shape[0], Tb - T) + arr.shape[2:], arr.dtype)
    return np.concatenate([arr, pad], axis=1)


class _ResNetScorer(_ShardedScoringMixin):
    """The ResNet-18 streams of an AU engine: the model's own eval-BN
    backbones, or with ``quantize="w8a8"`` their int8 trees, calibrated (and
    refined) from the fp32 fold."""

    _replica_attrs = ("model", "qbackbones")

    def __init__(self, model: nn.Module, sizes: dict, *, compute_dtype: torch.dtype,
                 quantize: Optional[str], device, mesh=None):
        """``sizes``: each stream's backbone attribute of ``model`` -> the
        image size its inputs are resized to (None: as given). ``mesh``: as
        :class:`VisualScorer`'s."""
        if quantize not in AU_QUANT_MODES:
            raise ValueError(f"quantize must be None or 'w8a8', got {quantize!r}")
        self.device = self._init_mesh(mesh, device)
        self.compute_dtype = compute_dtype
        self.quantize = quantize
        self.model = copy.deepcopy(model).to(self.device)
        self.sizes = dict(sizes)
        self.fp_trees = ({k: QuantizedResNet18.from_folded(
            fold_resnet18_bn(getattr(self.model, k))) for k in self.sizes}
            if quantize else None)
        self.qbackbones: Optional[dict] = None  # set by calibrate()

    def _flat(self, key: str, images_u8: np.ndarray) -> torch.Tensor:
        """uint8 ``(..., H, W, 3)`` -> stream ``key``'s flat fp32 images."""
        x = _prep(images_u8, self.sizes[key], self.device)
        return x.reshape((-1,) + tuple(x.shape[-3:]))

    def _calibrate_on(self, xs: dict, refine_passes: int) -> None:
        """Fit each stream on its flat images ``xs[stream]``; the refinement
        fits in IEEE fp32 whatever the compute dtype, as the Xception
        engines' does (ROADMAP Queue 3, F3)."""
        qb = {}
        for key, fp in self.fp_trees.items():
            amaxes = calibrate_resnet18_amax(fp, xs[key], compute_dtype=self.compute_dtype)
            qb[key] = quantize_folded_resnet18(fp, amaxes)
            if refine_passes:
                with ieee_fp32():
                    qb[key] = refine_quantized_resnet18(qb[key], fp, xs[key],
                                                        passes=refine_passes,
                                                        compute_dtype=torch.float32)
        self.qbackbones = qb
        self._replica_cache = None

    def _features(self, key: str, flat: torch.Tensor) -> torch.Tensor:
        if self.qbackbones is not None:
            return resnet18_quant_walk(self.qbackbones[key], flat, quant=True,
                                       compute_dtype=self.compute_dtype)
        return getattr(self.model, key)(flat, self.compute_dtype)

    def _backbone_fns(self) -> dict:
        """The ``*backbone_fn`` overrides of the model's apply: the int8 trees
        once calibrated, else none (the model's own eval ResNet-18s)."""
        if self.qbackbones is None:
            return {}
        return {f"{key}_fn": functools.partial(self._features, key) for key in self.sizes}

    @_ieee_fp32
    @torch.inference_mode()
    def features(self, key: str, images_u8: np.ndarray) -> torch.Tensor:
        """uint8 images ``(..., H, W, 3)`` -> per-image ResNet-18 features
        ``(N, 512)`` of stream ``key`` (a backbone attribute of the model) in
        the compute dtype: the path :meth:`score` takes. A quantized scorer
        must be calibrated first."""
        if self.quantize is not None and self.qbackbones is None:
            raise ValueError("calibrate() the quantized scorer before asking for its features")
        return self._features(key, self._flat(key, images_u8))


class AUFaceScorer(_ResNetScorer):
    """Cross-modal AU + face scoring (``AUFaceDetector``) on raw uint8 inputs,
    with the model's own logit head: ``sigmoid(logits[:, 0])``."""

    @classmethod
    def from_bundle(cls, path: str, lstm_hidden: int = 256, **kw) -> "AUFaceScorer":
        """Build from a ``train_au_face`` bundle (:func:`load_au_face_bundle`)."""
        return cls(load_au_face_bundle(path, lstm_hidden), **kw)

    def __init__(
        self,
        model: AUFaceDetector,
        *,
        compute_dtype: torch.dtype = torch.bfloat16,
        frame_size: Optional[Tuple[int, int]] = None,
        patch_size: Optional[Tuple[int, int]] = None,
        buckets: Optional[Sequence[int]] = None,
        quantize: Optional[str] = None,
        device="cuda",
        mesh=None,
    ):
        """``buckets``: both time axes pad up to a bucket, and their true
        lengths gate the biLSTMs, the cross-attention keys and the pools, so
        the scores equal the unbucketed ones. ``quantize``: None or
        ``"w8a8"``. ``mesh``: as :class:`VisualScorer`'s."""
        super().__init__(model, {"face_backbone": frame_size, "au_backbone": patch_size},
                         compute_dtype=compute_dtype, quantize=quantize, device=device,
                         mesh=mesh)
        self.buckets = tuple(sorted(buckets)) if buckets else None

    @_ieee_fp32
    def calibrate(self, videos_u8: np.ndarray, au_patches_u8: np.ndarray, *,
                  refine_passes: int = 0) -> None:
        """Fit the w8a8 face and AU ResNet-18s on a representative batch
        (no-op when ``quantize=None``); ``refine_passes > 0`` adds the affine
        refinement of both streams on the same batch."""
        if self.quantize is None:
            return
        with torch.inference_mode():
            xs = {"face_backbone": self._flat("face_backbone", np.asarray(videos_u8)),
                  "au_backbone": self._flat("au_backbone", np.asarray(au_patches_u8))}
        self._calibrate_on(xs, refine_passes)

    def _host_inputs(self, videos_u8, au_patches_u8, au_mask, au_weight) -> tuple:
        """The host side: the bucketed inputs as numpy arrays and both valid
        lengths, ``((videos, patches, mask, weight), T, Ta)``."""
        if self.quantize is not None and self.qbackbones is None:
            self.calibrate(videos_u8, au_patches_u8)  # implicit first-batch calibration
        B, T = videos_u8.shape[:2]
        Ta, A = au_patches_u8.shape[1:3]
        if au_mask is None:
            au_mask = np.ones((B, Ta, A), np.float32)
        if au_weight is None:
            au_weight = np.ones((B, Ta, A), np.float32)
        if self.buckets:
            Tb, Tab = bucket_length(T, self.buckets), bucket_length(Ta, self.buckets)
            videos_u8, au_patches_u8 = _pad_time(videos_u8, Tb), _pad_time(au_patches_u8, Tab)
            au_mask, au_weight = _pad_time(au_mask, Tab), _pad_time(au_weight, Tab)
            T, Ta = min(T, Tb), min(Ta, Tab)
        f32 = lambda a: np.asarray(a, np.float32)
        return (videos_u8, au_patches_u8, f32(au_mask), f32(au_weight)), T, Ta

    def _inputs(self, videos_u8, au_patches_u8, au_mask, au_weight) -> tuple:
        """:meth:`_host_inputs` as tensors on the device, ``(videos, patches,
        mask, weight, T, Ta)``."""
        arrays, T, Ta = self._host_inputs(videos_u8, au_patches_u8, au_mask, au_weight)
        return tuple(_to_device(a, self.device) for a in arrays) + (T, Ta)

    def _apply(self, videos_u8, au_patches_u8, au_mask, au_weight, v_valid: int, au_valid: int):
        """The detector on device tensors -> ``(logits, v_tokens, au_tokens)``."""
        return au_face_detector_apply(
            self.model, _prep_t(videos_u8, self.sizes["face_backbone"]),
            _prep_t(au_patches_u8, self.sizes["au_backbone"]), au_mask, au_weight,
            v_valid=v_valid, au_valid=au_valid, compute_dtype=self.compute_dtype,
            **self._backbone_fns())

    def _score_impl(self, videos_u8: torch.Tensor, au_patches_u8: torch.Tensor,
                    au_mask: torch.Tensor, au_weight: torch.Tensor, v_valid: int,
                    au_valid: int) -> torch.Tensor:
        """The device side of :meth:`score`: uint8 faces and AU patches, fp32
        ``au_mask`` and ``au_weight`` on the scorer's device and the valid
        lengths of both time axes -> fp32 fake probabilities ``(B,)``; the
        program ``models/export.py::export_au_face`` traces, with the
        lengths baked."""
        logits = self._apply(videos_u8, au_patches_u8, au_mask, au_weight, v_valid, au_valid)[0]
        return torch.sigmoid(logits[:, 0].float())

    @_ieee_fp32
    @torch.inference_mode()
    def score(self, videos_u8: np.ndarray, au_patches_u8: np.ndarray,
              au_mask: Optional[np.ndarray] = None,
              au_weight: Optional[np.ndarray] = None) -> np.ndarray:
        """``videos_u8 (B, T, H, W, 3)`` and ``au_patches_u8 (B, Ta, A, h, w, 3)``
        uint8, ``au_mask`` / ``au_weight (B, Ta, A)`` (ones by default) -> fake
        probabilities ``(B,)``."""
        arrays, T, Ta = self._host_inputs(videos_u8, au_patches_u8, au_mask, au_weight)
        return self._score_rows(arrays, T, Ta)

    @_ieee_fp32
    @torch.inference_mode()
    def embed(self, videos_u8: np.ndarray, au_patches_u8: np.ndarray,
              au_mask: Optional[np.ndarray] = None,
              au_weight: Optional[np.ndarray] = None) -> torch.Tensor:
        """The pooled embedding the head reads: the fp32 masked means of both
        token streams, concatenated, ``(B, 4 * lstm_hidden)``."""
        inputs = self._inputs(videos_u8, au_patches_u8, au_mask, au_weight)
        _, v_tokens, au_tokens = self._apply(*inputs)
        T, Ta = inputs[4:]
        return torch.cat([masked_mean(v_tokens, T), masked_mean(au_tokens, Ta)], dim=-1)


class AUPatchScorer(_ResNetScorer):
    """AU-patch ResNet-LSTM scoring (``AUPatchClassifier``) on raw uint8 patch
    stacks: ``sigmoid(logits[:, 0])``.

    The default ``mask_padding=True`` is the quality mode; the reference's
    pad-consuming forward for ``lengths < T`` is ``mask_padding=False``."""

    @classmethod
    def from_bundle(cls, path: str, hidden_dim: int = 128, lstm_hidden: int = 128,
                    **kw) -> "AUPatchScorer":
        """Build from a ``train_au_patch`` bundle (:func:`load_au_patch_bundle`)."""
        return cls(load_au_patch_bundle(path, hidden_dim, lstm_hidden), **kw)

    def __init__(
        self,
        model: AUPatchClassifier,
        *,
        compute_dtype: torch.dtype = torch.bfloat16,
        patch_size: Optional[Tuple[int, int]] = None,
        mask_padding: bool = True,
        buckets: Optional[Sequence[int]] = None,
        quantize: Optional[str] = None,
        device="cuda",
        mesh=None,
    ):
        """``buckets``: the time axis pads up to a bucket, ``lengths`` gates
        the biLSTM, so the scores equal the unbucketed ones. ``quantize``:
        None or ``"w8a8"``. ``mesh``: as :class:`VisualScorer`'s."""
        super().__init__(model, {"backbone": patch_size}, compute_dtype=compute_dtype,
                         quantize=quantize, device=device, mesh=mesh)
        self.mask_padding = mask_padding
        self.buckets = tuple(sorted(buckets)) if buckets else None

    @_ieee_fp32
    def calibrate(self, patches_u8: np.ndarray, *, refine_passes: int = 0) -> None:
        """Fit the w8a8 ResNet-18 on a representative patch batch (no-op when
        ``quantize=None``); ``refine_passes > 0`` adds the affine refinement."""
        if self.quantize is None:
            return
        with torch.inference_mode():
            x = self._flat("backbone", np.asarray(patches_u8))
        self._calibrate_on({"backbone": x}, refine_passes)

    def _host_inputs(self, patches_u8, au_weights, lengths) -> tuple:
        """The host side: the bucketed inputs as numpy arrays ``(patches,
        weights, lengths)``."""
        if self.quantize is not None and self.qbackbones is None:
            self.calibrate(patches_u8)  # implicit first-batch calibration
        B, T, A = patches_u8.shape[:3]
        if au_weights is None:
            au_weights = np.ones((B, T, A), np.float32)
        if lengths is None:
            lengths = np.full((B,), T, np.int64)
        if self.buckets:
            Tb = bucket_length(T, self.buckets)
            patches_u8, au_weights = _pad_time(patches_u8, Tb), _pad_time(au_weights, Tb)
            lengths = np.minimum(lengths, Tb)
        return patches_u8, np.asarray(au_weights, np.float32), np.asarray(lengths)

    def _inputs(self, patches_u8, au_weights, lengths) -> tuple:
        """:meth:`_host_inputs` as tensors on the device."""
        return tuple(_to_device(a, self.device)
                     for a in self._host_inputs(patches_u8, au_weights, lengths))

    def _apply(self, patches_u8, au_weights, lengths, return_pooled: bool):
        return au_patch_classifier_apply(
            self.model, _prep_t(patches_u8, self.sizes["backbone"]), au_weights,
            lengths=lengths.long(), mask_padding=self.mask_padding,
            compute_dtype=self.compute_dtype, return_pooled=return_pooled,
            **self._backbone_fns())

    def _score_impl(self, patches_u8: torch.Tensor, au_weights: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
        """The device side of :meth:`score`: uint8 patches, fp32 weights and
        integer lengths on the scorer's device -> fp32 fake probabilities
        ``(B,)``; the program ``models/export.py::export_au_patch`` traces."""
        logits = self._apply(patches_u8, au_weights, lengths, False)
        return torch.sigmoid(logits[:, 0].float())

    @_ieee_fp32
    @torch.inference_mode()
    def score(self, patches_u8: np.ndarray, au_weights: Optional[np.ndarray] = None,
              lengths: Optional[np.ndarray] = None) -> np.ndarray:
        """``patches_u8 (B, T, A, h, w, 3)`` uint8, ``au_weights (B, T, A)``
        (ones by default), ``lengths (B,)`` (T by default) -> fake
        probabilities ``(B,)``."""
        return self._score_rows(self._host_inputs(patches_u8, au_weights, lengths))

    @_ieee_fp32
    @torch.inference_mode()
    def embed(self, patches_u8: np.ndarray, au_weights: Optional[np.ndarray] = None,
              lengths: Optional[np.ndarray] = None) -> torch.Tensor:
        """The fp32 pooled embedding before the classifier, ``(B, 2 * lstm_hidden)``."""
        return self._apply(*self._inputs(patches_u8, au_weights, lengths), True)
