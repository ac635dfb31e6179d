"""Visual serving engine: uint8 clips -> fake probabilities.

Counterpart of ``multimodal_deepfake_detection_tpu/models/serve.py::
VisualScorer``. One call of :meth:`VisualScorer.score`:

1. uint8 ``(B, T, H, W, 3)`` -> fp32 / 255, optional bilinear resize;
2. BN-folded Xception over the B*T frames, the 8 middle-flow blocks through
   the K1 kernel when the tensors are on CUDA (with ``middle_taps="bf16"`` in
   bf16 tap order), with ``fuse_entry`` the 4 stride-2 blocks through the K3
   kernel or with ``entry_pair`` their separable pairs through K4, and with
   ``fuse_exit`` the exit sepconvs through K5 (``models/fold.py``); or, with
   ``quantize``, the w8a8 tree (``models/quant.py``);
3. LSTM over T in the compute dtype, last valid step;
4. ArcFace cosine logits (s=30) in fp32, softmax fake probability.

Clips are padded (or cut) to a length bucket as the JAX engine does, so the
scores match it; the JAX meshes and jit cache are not ported here.

The quantization modes are the JAX engine's: ``"w8a8"`` (every conv and
depthwise int8), ``"w8a8-hybrid"`` (int8 entry and exit, the fp middle flow
through K1) and ``"w8a8-pallas"`` (int8 throughout, the middle flow through
K2). The first :meth:`VisualScorer.score` calibrates on its batch unless
:meth:`VisualScorer.calibrate` ran before.

``compute_dtype=torch.float32`` means IEEE fp32 on the card: every forward
of the scorer runs with cuDNN's TF32 switched off (torch's default lets
cuDNN round fp32 convolution inputs to TF32's 10-bit mantissa), and the
switch is restored when the call returns or raises.
"""
from __future__ import annotations

import copy
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.checkpoint import load_bundle, merge_params
from ..data.collate import bucket_length
from ..ops.lstm import lstm_apply, select_last_step
from ..ops.resize import resize_bilinear
from ..utils.jax_weights import (
    arcface_from_jax,
    arcface_to_jax,
    xception_lstm_from_jax,
    xception_lstm_to_jax,
)
from .fold import check_routes, fold_xception_bn
from .heads import ArcFace, XceptionLSTM, arcface_apply
from .quant import (
    QuantizedXception,
    calibrate_amax,
    quantize_folded_xception,
    xception_quant_walk,
)

QUANT_MODES = (None, "w8a8", "w8a8-hybrid", "w8a8-pallas")


def _ieee_fp32(method):
    """Runs a scorer's forward with cuDNN's TF32 off when it computes in
    fp32, restoring the process's setting on return or raise; bf16 scoring
    leaves the setting alone."""
    @functools.wraps(method)
    def run(self, *args, **kw):
        if self.compute_dtype != torch.float32:
            return method(self, *args, **kw)
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return method(self, *args, **kw)
        finally:
            torch.backends.cudnn.allow_tf32 = before
    return run


def load_visual_bundle(path: str, hidden_dim: int = 128) -> Tuple[XceptionLSTM, ArcFace]:
    """Read a JAX ``train_visual`` bundle ``{model, arcface[, state]}``.

    ``model`` and ``arcface`` merge strictly onto a freshly initialised tree
    of the same shapes, so no initial value survives; ``state`` merges
    leniently (missing BN statistics keep their init, mean 0 and var 1), as
    the JAX loader does.
    """
    g = torch.Generator().manual_seed(0)
    params, state = xception_lstm_to_jax(XceptionLSTM(hidden_dim, generator=g))
    arc = arcface_to_jax(ArcFace(hidden_dim, 2, generator=g))
    bundle = load_bundle(path)
    params = merge_params(params, bundle["model"], strict=True)
    arc = merge_params(arc, bundle["arcface"], strict=True)
    if "state" in bundle:
        state = merge_params(state, bundle["state"], strict=False)
    return xception_lstm_from_jax(params, state), arcface_from_jax(arc)


class VisualScorer:
    """XceptionLSTMV + ArcFace scoring on raw uint8 frame stacks."""

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
    ):
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
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        # the fp path's weights, stored in the compute dtype; a quantized
        # scorer serves the w8a8 tree instead and folds only at fp32 (below)
        self.folded_backbone = (
            None if quantize else fold_xception_bn(model.backbone, compute_dtype).to(self.device)
        )
        self.lstm = copy.deepcopy(model.lstm).to(self.device)
        self.arcface_w = arcface.w.detach().to(self.device, torch.float32)
        self.arcface_s = arcface_s
        self.frame_size = frame_size
        self.mask_padding = mask_padding
        self.use_kernels = self.device.type == "cuda" if use_kernels is None else use_kernels
        # length buckets: T pads up to a bucket, as in the JAX engine
        self.buckets = tuple(buckets) if buckets else None
        self.quantize = quantize
        self.routes = dict(fuse_entry=fuse_entry, entry_pair=entry_pair, middle_taps=middle_taps,
                           fuse_exit=fuse_exit)
        # the quantizer reads fp32 folded weights: quantizing the compute-dtype
        # fold would round every weight twice
        self.fp_tree = (
            QuantizedXception.from_folded(fold_xception_bn(model.backbone, torch.float32))
            .to(self.device) if quantize else None
        )
        self.qbackbone: Optional[QuantizedXception] = None  # set by calibrate()

    def _frames_to_x(self, frames_u8: np.ndarray) -> torch.Tensor:
        B, T = frames_u8.shape[:2]
        u8 = torch.from_numpy(np.ascontiguousarray(frames_u8)).to(self.device)
        x = u8.reshape((B * T,) + tuple(u8.shape[2:])).float() / 255.0
        if self.frame_size is not None and tuple(x.shape[1:3]) != tuple(self.frame_size):
            x = resize_bilinear(x, self.frame_size)
        return x

    @_ieee_fp32
    def calibrate(self, frames_u8: np.ndarray, *, refine_passes: int = 0) -> None:
        """Fit the w8a8 activation scales on a representative uint8 frame
        batch ``(B, T, H, W, 3)`` and switch the backbone to the quantized
        tree (no-op when ``quantize=None``). The depthwise convs are
        quantized too; ``"w8a8-hybrid"`` leaves the middle flow fp."""
        if self.quantize is None:
            return
        if refine_passes:
            raise NotImplementedError(
                "refine_passes > 0: the affine refinement (refine_quantized_xception) is not "
                "ported yet (ROADMAP Queue 1 item 6)")
        x = self._frames_to_x(np.asarray(frames_u8))
        amaxes = calibrate_amax(self.fp_tree, x, compute_dtype=self.compute_dtype)
        self.qbackbone = quantize_folded_xception(
            self.fp_tree, amaxes, quant_depthwise=True,
            skip_middle=self.quantize == "w8a8-hybrid",
        )

    @_ieee_fp32
    @torch.inference_mode()
    def frame_features(self, frames_u8: np.ndarray) -> torch.Tensor:
        """``(B, T, H, W, 3)`` uint8 -> per-frame features ``(B, T, 2048)`` in
        the compute dtype, on the scorer's device. A quantized scorer not yet
        calibrated calibrates on this batch first, as :meth:`score` does."""
        if self.quantize is not None and self.qbackbone is None:
            self.calibrate(frames_u8)
        B, T = frames_u8.shape[:2]
        x = self._frames_to_x(frames_u8)
        if self.qbackbone is not None:
            feats = xception_quant_walk(
                self.qbackbone, x, quant=True, compute_dtype=self.compute_dtype,
                features_only=True, fuse_middle=self.quantize != "w8a8",
                use_kernels=self.use_kernels,
            )
        else:
            feats = self.folded_backbone(x, features_only=True, use_kernels=self.use_kernels,
                                         **self.routes)
        return feats.reshape(B, T, -1)

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
        feats = self.frame_features(frames_u8)
        outputs, _ = lstm_apply(self.lstm, feats, compute_dtype=self.compute_dtype)
        lengths_t = torch.as_tensor(np.asarray(lengths), dtype=torch.long, device=self.device)
        emb = select_last_step(outputs, lengths_t, mask_padding=self.mask_padding)
        logits = arcface_apply(self.arcface_w, emb, s=self.arcface_s)
        return torch.softmax(logits, dim=-1)[:, 1].cpu().numpy()
