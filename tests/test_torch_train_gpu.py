"""The port's visual train step on the GPU, at a small size.

Marked ``gpu``; skips where CUDA is absent. Run on a machine with an H100:
``python -m pytest --noconftest tests/test_torch_train_gpu.py -q``. One bf16
Adam step of the ``train_visual`` forward (full-width Xception, hidden 128,
B=2, T=2, 64^2) on the card: the loss and probabilities stay on the device
and are finite, every parameter the loss reaches and every running
statistic moves. One fp32 SGD step on the card (TF32 off) against the same
step on the CPU from the same weights, at ``chip_smoke.py``'s bars: the
loss within 1e-5 relative, each running statistic within 1e-4 of its
tensor's largest, every post-step delta within 1e-1 of the largest delta
(fp32 roundoff of the card's weight gradients reads 3.63e-2 at these
weights). The same step in fp64, whose card-against-CPU difference is
roundoff: 1e-12, 1e-10 and 1e-9.
"""
import numpy as np
import pytest
import torch

from multimodal_deepfake_detection_tpu_torch.cli import train_visual as tv
from multimodal_deepfake_detection_tpu_torch.core.precision import ieee_fp32
from multimodal_deepfake_detection_tpu_torch.models.heads import XceptionLSTMArcFace
from multimodal_deepfake_detection_tpu_torch.train import TrainState, make_optimizer
from multimodal_deepfake_detection_tpu_torch.train.optim import Optimizer
from multimodal_deepfake_detection_tpu_torch.train.steps import make_train_step

pytestmark = pytest.mark.gpu

B, T, SIZE = 2, 2, 64
BARS = {  # chip_smoke.py's TRAIN_CPU_BARS and TRAIN_CPU_BARS_FP64
    "float32": {"loss": 1e-5, "stats": 1e-4, "deltas": 1e-1},
    "float64": {"loss": 1e-12, "stats": 1e-10, "deltas": 1e-9},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch():
    rng = np.random.default_rng(0)
    return (rng.random((B, T, SIZE, SIZE, 3), dtype=np.float32),
            np.array([0.0, 1.0], np.float32), np.array([T, 1], np.int32))


def _step(model, opt, cdtype, device, video_dtype=torch.float32):
    forward = tv.make_forward(tv.Config(), cdtype)

    def loss_forward(m, rng_seed, b):
        loss, bn_stats, probs = forward(m, b, True)
        return loss, (bn_stats, probs)

    video, labels, lengths = tv.to_device(_batch(), device)
    with ieee_fp32():
        _, loss, probs = make_train_step(loss_forward)(
            TrainState(0, model, opt), (video.to(video_dtype), labels, lengths), 0)
    return loss, probs


def test_bf16_train_step_on_the_card(cuda):
    model = XceptionLSTMArcFace(128, generator=torch.Generator().manual_seed(0)).to(cuda)
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    loss, probs = _step(model, make_optimizer(model.parameters(), "adam", 1e-4,
                                              weight_decay=1e-4, grad_clip=1.0),
                        torch.bfloat16, cuda)
    assert loss.device.type == probs.device.type == "cuda"
    assert torch.isfinite(loss) and torch.isfinite(probs).all()
    for n, t in model.state_dict().items():
        assert not torch.equal(t, before[n]), f"{n} did not move"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_train_step_matches_the_cpu(cuda, dtype):
    sd = XceptionLSTMArcFace(128, generator=torch.Generator().manual_seed(1)).state_dict()
    dt = getattr(torch, dtype)
    out = {}
    for device in ("cpu", "cuda"):
        model = XceptionLSTMArcFace(128)
        model.load_state_dict(sd)
        model.to(device, dt)
        opt = Optimizer(torch.optim.SGD(model.parameters(), lr=0.05), grad_clip=1.0)
        loss, _ = _step(model, opt, dt, torch.device(device), dt)
        out[device] = float(loss), {n: t.detach().double().cpu()
                                    for n, t in model.state_dict().items()}
    (l_cpu, s_cpu), (l_gpu, s_gpu) = out["cpu"], out["cuda"]
    params = {n for n, _ in XceptionLSTMArcFace(128).named_parameters()}
    deltas = {n: (s_gpu[n] - sd[n].double(), s_cpu[n] - sd[n].double()) for n in params}
    global_delta = max(dc.abs().max().item() for _, dc in deltas.values())
    err = {
        "loss": abs(l_gpu - l_cpu) / abs(l_cpu),
        "stats": max(((s_gpu[n] - s_cpu[n]).abs().max() / s_cpu[n].abs().max()).item()
                     for n in set(s_cpu) - params),
        "deltas": max((dg - dc).abs().max().item() for dg, dc in deltas.values()) / global_delta,
    }
    assert all(err[k] <= BARS[dtype][k] for k in BARS[dtype]), err
