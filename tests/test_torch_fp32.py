"""``VisualScorer(compute_dtype=torch.float32)`` is IEEE fp32: its forwards
run with cuDNN's TF32 switched off, and the process's setting comes back
when they return or raise. bf16 scoring leaves the setting alone. The same
holds for ``AUPatchScorer`` and ``AUFaceScorer``, whose refinement also
fits in IEEE fp32 whatever their compute dtype.

A probe module in the backbone's place (or in the calibration's) reads the
flag while the forward runs; the CPU build carries the same flag as the
card's.
"""
import numpy as np
import pytest
import torch

from multimodal_deepfake_detection_tpu_torch.models import serve
from multimodal_deepfake_detection_tpu_torch.models.heads import ArcFace, XceptionLSTM
from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer

HIDDEN = 8


class Probe(torch.nn.Module):
    """Stands in for the folded backbone: records cuDNN's TF32 flag on each
    call and returns zero features, or raises if ``fail``."""

    def __init__(self, fail=False):
        super().__init__()
        self.seen, self.fail = [], fail

    def forward(self, x, **kw):
        self.seen.append(torch.backends.cudnn.allow_tf32)
        if self.fail:
            raise RuntimeError("probe")
        return torch.zeros((x.shape[0], 2048), dtype=x.dtype)


@pytest.fixture(scope="module")
def parts():
    g = torch.Generator().manual_seed(0)
    return XceptionLSTM(HIDDEN, generator=g), ArcFace(HIDDEN, 2, generator=g)


@pytest.fixture
def tf32_on(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)


def _frames():
    return np.random.default_rng(0).integers(0, 256, (2, 3, 8, 8, 3), dtype=np.uint8)


@pytest.mark.parametrize("method", ["score", "frame_features"])
def test_fp32_forward_runs_without_tf32(parts, tf32_on, method):
    scorer = VisualScorer(*parts, compute_dtype=torch.float32, device="cpu")
    scorer.folded_backbone = probe = Probe()
    getattr(scorer, method)(_frames())
    assert probe.seen == [False]
    assert torch.backends.cudnn.allow_tf32


def test_fp32_calibration_runs_without_tf32(parts, tf32_on, monkeypatch):
    seen = []

    def calibrate_amax(*args, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        raise RuntimeError("probe")

    monkeypatch.setattr(serve, "calibrate_amax", calibrate_amax)
    scorer = VisualScorer(*parts, compute_dtype=torch.float32, quantize="w8a8", device="cpu")
    with pytest.raises(RuntimeError, match="probe"):
        scorer.calibrate(_frames())
    assert seen == [False] and torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("method", ["score", "frame_features"])
def test_fp32_flag_restored_after_an_exception(parts, tf32_on, method):
    scorer = VisualScorer(*parts, compute_dtype=torch.float32, device="cpu")
    scorer.folded_backbone = probe = Probe(fail=True)
    with pytest.raises(RuntimeError, match="probe"):
        getattr(scorer, method)(_frames())
    assert probe.seen == [False]
    assert torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("flag", [True, False])
def test_bf16_scoring_leaves_the_flag_alone(parts, monkeypatch, flag):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", flag)
    scorer = VisualScorer(*parts, device="cpu")
    scorer.folded_backbone = probe = Probe()
    scorer.score(_frames())
    assert probe.seen == [flag] and torch.backends.cudnn.allow_tf32 == flag


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_refinement_fits_in_ieee_fp32(parts, tf32_on, monkeypatch, dtype):
    """``calibrate(refine_passes=1)`` refines in fp32 with TF32 off, whatever
    the scorer's compute dtype (calibration itself runs in the compute
    dtype), and the process's flag comes back."""
    seen = []

    def refine(qtree, fp_tree, x, *, passes, compute_dtype):
        seen.append((passes, compute_dtype, torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return qtree

    monkeypatch.setattr(serve, "refine_quantized_xception", refine)
    scorer = VisualScorer(*parts, compute_dtype=dtype, quantize="w8a8", device="cpu")
    scorer.calibrate(_frames(), refine_passes=1)
    assert seen == [(1, torch.float32, False, False)]
    assert torch.backends.cudnn.allow_tf32 and scorer.qbackbone is not None


# --- the AU engines -------------------------------------------------------------

class ResNetProbe(torch.nn.Module):
    """Stands in for a ResNet-18 stream: records cuDNN's TF32 flag and
    returns zero features, or raises if ``fail``."""

    def __init__(self, fail=False):
        super().__init__()
        self.seen, self.fail = [], fail

    def forward(self, x, compute_dtype=None):
        self.seen.append(torch.backends.cudnn.allow_tf32)
        if self.fail:
            raise RuntimeError("probe")
        return torch.zeros((x.shape[0], 512), dtype=compute_dtype or x.dtype)


def _au_scorer(engine, **kw):
    """An AU scorer over a small seeded model, its stream probed, and its
    ``score`` inputs."""
    from multimodal_deepfake_detection_tpu_torch.models.au_face import AUFaceDetector
    from multimodal_deepfake_detection_tpu_torch.models.resnet_lstm import AUPatchClassifier
    from multimodal_deepfake_detection_tpu_torch.models.serve import AUFaceScorer, AUPatchScorer

    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    patches = rng.integers(0, 256, (1, 2, 2, 8, 8, 3), dtype=np.uint8)
    if engine == "au_patch":
        return AUPatchScorer(AUPatchClassifier(8, 4, generator=g), device="cpu", **kw), (patches,)
    videos = rng.integers(0, 256, (1, 2, 8, 8, 3), dtype=np.uint8)
    return AUFaceScorer(AUFaceDetector(4, generator=g), device="cpu", **kw), (videos, patches)


@pytest.mark.parametrize("engine", ["au_patch", "au_face"])
@pytest.mark.parametrize("fail", [False, True])
def test_au_fp32_score_runs_without_tf32(tf32_on, engine, fail):
    """fp32 ``score`` runs every stream with TF32 off, and the flag comes
    back when it returns or raises."""
    scorer, args = _au_scorer(engine, compute_dtype=torch.float32)
    key = "backbone" if engine == "au_patch" else "au_backbone"
    setattr(scorer.model, key, probe := ResNetProbe(fail))
    if fail:
        with pytest.raises(RuntimeError, match="probe"):
            scorer.score(*args)
    else:
        scorer.score(*args)
    assert probe.seen == [False] and torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("engine", ["au_patch", "au_face"])
def test_au_bf16_scoring_leaves_the_flag_alone(tf32_on, engine):
    scorer, args = _au_scorer(engine)
    key = "backbone" if engine == "au_patch" else "face_backbone"
    setattr(scorer.model, key, probe := ResNetProbe())
    scorer.score(*args)
    assert probe.seen == [True] and torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("engine", ["au_patch", "au_face"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_au_calibration_and_refinement_in_ieee_fp32(tf32_on, monkeypatch, engine, dtype):
    """``calibrate(refine_passes=1)`` of an AU scorer: the calibration with
    TF32 off when the scorer computes in fp32 (on when bf16), each stream's
    refinement in fp32 with TF32 off whatever the compute dtype; the
    process's flag comes back."""
    calib, refined = [], []
    real_calibrate = serve.calibrate_resnet18_amax

    def calibrate(*args, **kw):
        calib.append(torch.backends.cudnn.allow_tf32)
        return real_calibrate(*args, **kw)

    def refine(qtree, fp_tree, x, *, passes, compute_dtype):
        refined.append((passes, compute_dtype, torch.backends.cudnn.allow_tf32,
                        torch.backends.cuda.matmul.allow_tf32))
        return qtree

    monkeypatch.setattr(serve, "calibrate_resnet18_amax", calibrate)
    monkeypatch.setattr(serve, "refine_quantized_resnet18", refine)
    scorer, args = _au_scorer(engine, compute_dtype=dtype, quantize="w8a8")
    scorer.calibrate(*args, refine_passes=1)
    streams = 1 if engine == "au_patch" else 2
    assert calib == [dtype != torch.float32] * streams
    assert refined == [(1, torch.float32, False, False)] * streams
    assert torch.backends.cudnn.allow_tf32 and len(scorer.qbackbones) == streams
