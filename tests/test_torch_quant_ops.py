"""The port's int8 primitives against the JAX package's ``ops/quant.py``, fp32 on the CPU.

Inputs come from numpy seeds and go through both packages; weights cross as
OIHW <-> HWIO. Codes must be identical; outputs agree at rtol = atol = 1e-6
(the int32 sums are exact on both sides, so only the fp32 epilogue could
differ).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.ops import quant as jq  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.ops import quant as tq  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _hwio(w: np.ndarray) -> jnp.ndarray:
    return jnp.asarray(w.transpose(2, 3, 1, 0))


def test_quantize_codes_identical_incl_ties():
    rng = np.random.default_rng(0)
    scale = np.float32(2.0 ** -6)  # exact ties at (k + 0.5) * scale
    ties = (rng.integers(-140, 140, 512) + 0.5).astype(np.float32) * scale
    x = np.concatenate([ties, rng.normal(0, 1, 2048).astype(np.float32)])
    for s in (scale, np.float32(0.0123)):
        got = tq.quantize(torch.from_numpy(x), torch.tensor(s)).numpy()
        ref = np.asarray(jq.quantize(jnp.asarray(x), jnp.float32(s)))
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, ref)


def test_quantize_weight_per_output_channel():
    w = np.random.default_rng(1).normal(0, 0.3, (24, 16, 3, 3)).astype(np.float32)
    w_q, s_w = tq.quantize_weight(torch.from_numpy(w))
    jw_q, js_w = jq.quantize_weight(_hwio(w))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jw_q).transpose(3, 2, 0, 1))
    np.testing.assert_allclose(s_w.numpy(), np.asarray(js_w), rtol=1e-6)
    assert abs(tq.dequant_error(torch.from_numpy(w)) - jq.dequant_error(_hwio(w))) < 1e-7


def _conv_case(rng, N, H, Ci, Co, k, channel_scales):
    x = rng.normal(0, 1, (N, H, H, Ci)).astype(np.float32)
    w = rng.normal(0, 0.2, (Co, Ci, k, k)).astype(np.float32)
    b = rng.normal(0, 0.1, (Co,)).astype(np.float32)
    s_dq = np.float32(2.5 / 127)
    s_in = ((s_dq * rng.uniform(0.5, 2.0, Ci)).astype(np.float32) if channel_scales else s_dq)
    w_q, s_w = tq.quantize_weight(torch.from_numpy(w))
    node = {"w_q": jnp.asarray(w_q.numpy().transpose(2, 3, 1, 0)), "s_w": jnp.asarray(s_w.numpy()),
            "s_in": jnp.asarray(s_in), "b": jnp.asarray(b)}
    if channel_scales:
        node["s_dq"] = jnp.asarray(s_dq)
    t = dict(w_q=w_q, s_w=s_w, s_in=torch.as_tensor(s_in), b=torch.from_numpy(b),
             s_dq=torch.as_tensor(s_dq) if channel_scales else None)
    return x, node, t


@pytest.mark.parametrize(
    "N,H,Ci,Co,k,stride,padding,channel_scales",
    [
        (3, 6, 16, 24, 1, 1, 0, True),  # pointwise
        (3, 7, 16, 24, 1, 2, 0, False),  # 1x1/s2 skip, odd H
        (2, 11, 3, 32, 3, 2, 0, False),  # conv1: 3x3/s2, Cin = 3 (K = 27 pads to 32)
        (2, 9, 32, 64, 3, 1, 0, True),  # conv2: 3x3, Cin = 32
        (5, 2, 16, 24, 1, 1, 0, True),  # M = 20 > 16
        (3, 2, 24, 16, 1, 1, 0, False),  # M = 12 <= 16: padded rows
        (1, 1, 24, 16, 1, 1, 0, True),  # M = 1
        (2, 5, 8, 16, 3, 1, 1, True),  # zero padding in the quantized domain
    ],
)
def test_conv2d_w8a8_matches_jax(N, H, Ci, Co, k, stride, padding, channel_scales):
    rng = np.random.default_rng(N * 100 + H * 10 + k)
    x, node, t = _conv_case(rng, N, H, Ci, Co, k, channel_scales)
    ref = np.asarray(jq.conv2d_w8a8(node, jnp.asarray(x), stride=stride, padding=padding,
                                    out_dtype=jnp.float32))
    got = tq.conv2d_w8a8(torch.from_numpy(x), t["w_q"], t["s_w"], t["s_in"], t["b"], t["s_dq"],
                         stride=stride, padding=padding, out_dtype=torch.float32).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("channel_scales", [False, True])
@pytest.mark.parametrize("N,H", [(3, 8), (5, 4), (3, 2), (7, 1)])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_depthwise_w8a8_matches_jax(N, H, channel_scales, use_kernels):
    """8x8 takes XLA's grouped conv in JAX, <= 16 positions its shift-add;
    the port's plain version is the shift-add at every size. On a CPU
    tensor ``use_kernels`` reaches the kernel wrapper, which takes it too."""
    rng = np.random.default_rng(N * 10 + H)
    C = 24
    x = rng.normal(0, 1, (N, H, H, C)).astype(np.float32)
    w = rng.normal(0, 0.3, (C, 1, 3, 3)).astype(np.float32)
    s_dq = np.float32(2.5 / 127)
    s_in = (s_dq * rng.uniform(0.5, 2.0, C)).astype(np.float32) if channel_scales else s_dq
    w_q, s_w = tq.quantize_weight(torch.from_numpy(w))
    node = {"w_q": jnp.asarray(w_q.numpy().transpose(2, 3, 1, 0)), "s_w": jnp.asarray(s_w.numpy()),
            "s_in": jnp.asarray(s_in)}
    if channel_scales:
        node["s_dq"] = jnp.asarray(s_dq)
    ref = np.asarray(jq.depthwise_conv2d_w8a8(node, jnp.asarray(x), padding=1,
                                              out_dtype=jnp.float32))
    got = tq.depthwise_conv2d_w8a8(
        torch.from_numpy(x), w_q, s_w, torch.as_tensor(s_in),
        torch.as_tensor(s_dq) if channel_scales else None, out_dtype=torch.float32,
        use_kernels=use_kernels).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_absmax_scale_floor():
    z = torch.zeros(4, 3)
    assert float(tq.absmax_scale(z)) == pytest.approx(1e-12 / 127)
    np.testing.assert_allclose(tq.absmax_scale(torch.tensor([[1.0, -2.0], [0.5, 0.0]]), dim=1),
                               [2 / 127, 0.5 / 127], rtol=1e-7)
