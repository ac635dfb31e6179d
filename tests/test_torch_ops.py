"""Port ops against the JAX package's ops, fp32, on the CPU.

The same numpy inputs go through both packages; every bound is rtol 1e-5,
atol 1e-6.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.models import heads as jheads  # noqa: E402
from multimodal_deepfake_detection_tpu.ops import conv as jconv  # noqa: E402
from multimodal_deepfake_detection_tpu.ops import lstm as jlstm  # noqa: E402
from multimodal_deepfake_detection_tpu.ops.resize import resize_bilinear as jresize  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.core import checkpoint as tckpt  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.heads import arcface_apply  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.ops import conv as tconv  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.ops.lstm import (  # noqa: E402
    LSTM,
    lstm_apply,
    select_last_step,
)
from multimodal_deepfake_detection_tpu_torch.ops.resize import resize_bilinear  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "k,cin,cout,stride,padding,groups",
    [(3, 6, 10, 2, 0, 1), (3, 8, 8, 1, 1, 8), (1, 12, 5, 2, 0, 1), (3, 4, 6, 1, 1, 1)],
)
def test_conv2d_matches_jax(k, cin, cout, stride, padding, groups):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 11, cin)).astype(np.float32)
    w = rng.normal(0, 0.3, (k, k, cin // groups, cout)).astype(np.float32)  # HWIO
    b = rng.normal(size=(cout,)).astype(np.float32)
    ref = jconv.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                       stride=stride, padding=padding, groups=groups)
    got = tconv.conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b), stride=stride,
                       padding=padding, groups=groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_max_pool_and_global_avg_pool_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 8, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tconv.max_pool2d(_t(x), 3, 2, 1).numpy(), np.asarray(jconv.max_pool2d(jnp.asarray(x), 3, 2, 1))
    )
    np.testing.assert_allclose(
        tconv.global_avg_pool(_t(x)).numpy(), np.asarray(jconv.global_avg_pool(jnp.asarray(x))), **TOL
    )
    # bf16 in -> fp32 mean -> bf16 out, as in JAX
    xb = _t(x).to(torch.bfloat16)
    got = tconv.global_avg_pool(xb)
    ref = jconv.global_avg_pool(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_linear_and_batch_norm_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 16)).astype(np.float32)
    w = rng.normal(size=(16, 7)).astype(np.float32)
    b = rng.normal(size=(7,)).astype(np.float32)
    ref = jconv.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = tconv.linear(_t(x), _t(w.T), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    xi = rng.normal(size=(2, 3, 3, 7)).astype(np.float32)
    scale, bias = rng.normal(size=(2, 7)).astype(np.float32)
    mean = rng.normal(size=(7,)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, (7,)).astype(np.float32)
    ref, _ = jconv.batch_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                              {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
                              jnp.asarray(xi), train=False)
    got = tconv.batch_norm_eval(_t(xi), _t(scale), _t(bias), _t(mean), _t(var))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("out_hw", [(20, 26), (5, 4), (13, 13)])
def test_resize_bilinear_matches_jax(out_hw):
    x = np.random.default_rng(3).random((2, 13, 13, 3)).astype(np.float32)
    ref = jresize(jnp.asarray(x), out_hw)
    got = resize_bilinear(_t(x), out_hw)
    assert tuple(got.shape) == (2,) + out_hw + (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _lstm_pair(rng, D, H):
    w = {
        "w_ih": rng.uniform(-0.3, 0.3, (D, 4 * H)).astype(np.float32),
        "w_hh": rng.uniform(-0.3, 0.3, (H, 4 * H)).astype(np.float32),
        "b_ih": rng.uniform(-0.3, 0.3, (4 * H,)).astype(np.float32),
        "b_hh": rng.uniform(-0.3, 0.3, (4 * H,)).astype(np.float32),
    }
    mod = LSTM(D, H)
    with torch.no_grad():
        for k, v in w.items():
            getattr(mod, k).copy_(_t(v))
    return {k: jnp.asarray(v) for k, v in w.items()}, mod


@pytest.mark.parametrize("mode", ["mask", "fidelity", "none"])
def test_lstm_and_select_last_step_match_jax(mode):
    rng = np.random.default_rng(4)
    B, T, D, H = 3, 5, 12, 6
    jp, mod = _lstm_pair(rng, D, H)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    lengths = np.array([5, 2, 3], np.int32)
    ref_out, (ref_h, ref_c) = jlstm.lstm_apply(jp, jnp.asarray(x))
    with torch.no_grad():
        out, (h, c) = lstm_apply(mod, _t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), **TOL)
    jl = None if mode == "none" else jnp.asarray(lengths)
    tl = None if mode == "none" else torch.from_numpy(lengths)
    ref = jlstm.select_last_step(ref_out, jl, mask_padding=mode == "mask")
    got = select_last_step(out, tl, mask_padding=mode == "mask")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("with_labels", [False, True])
def test_arcface_matches_jax(with_labels):
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(6, 8)).astype(np.float32)
    w = rng.normal(size=(2, 8)).astype(np.float32)
    feats[0] = w[1] * 3.0  # cos = 1: exercises the acos clip
    labels = np.array([1, 0, 1, 1, 0, 0], np.int32)
    ref = jheads.arcface_apply({"w": jnp.asarray(w)}, jnp.asarray(feats),
                               jnp.asarray(labels) if with_labels else None)
    got = arcface_apply(_t(w), _t(feats), torch.from_numpy(labels) if with_labels else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bundle_roundtrip_and_strict_merge(tmp_path):
    rng = np.random.default_rng(6)
    tree = {"a": {"w": rng.normal(size=(2, 3))}, "blocks": [{"b": np.arange(4)}, {"b": np.ones(2)}]}
    path = str(tmp_path / "b.npz")
    tckpt.save_bundle(path, {"model": tree})
    back = tckpt.load_bundle(path)["model"]
    np.testing.assert_array_equal(back["a"]["w"], tree["a"]["w"])
    assert isinstance(back["blocks"], list) and len(back["blocks"]) == 2
    merged = tckpt.merge_params(tree, back, strict=True)
    np.testing.assert_array_equal(merged["blocks"][0]["b"], np.arange(4))
    with pytest.raises(KeyError):
        tckpt.merge_params({"x": np.zeros(1), **tree}, back, strict=True)
    with pytest.raises(ValueError):
        tckpt.merge_params({"a": {"w": np.zeros((3, 3))}}, back, strict=True)
    lenient = tckpt.merge_params({"x": np.zeros(1), "a": {"w": np.zeros((2, 3))}}, back, strict=False)
    np.testing.assert_array_equal(lenient["x"], np.zeros(1))


@pytest.mark.parametrize("buckets", [None, (), (4,), (25, 50, 75)])
def test_bucket_length_matches_jax(buckets):
    from multimodal_deepfake_detection_tpu.data.collate import bucket_length as jbucket
    from multimodal_deepfake_detection_tpu_torch.data.collate import bucket_length

    for t in range(1, 90):
        assert bucket_length(t, buckets) == jbucket(t, buckets)


def test_serve_config_keeps_jax_names_and_defaults():
    import dataclasses

    from multimodal_deepfake_detection_tpu.cli.serve import Config as JaxConfig
    from multimodal_deepfake_detection_tpu_torch.cli.serve import Config, parse_config

    jax_defaults = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    # the port's own flags (the JAX route to K3 is the MDFD_ENTRY_FUSE_H env
    # gate; the JAX package routes K4, K5 and v2's bf16 taps only in its tools)
    port_only = {"device", "fuse_entry", "entry_pair", "middle_taps", "fuse_exit"}
    for f in dataclasses.fields(Config):
        if f.name not in port_only:
            assert f.default == jax_defaults[f.name], f.name
    assert port_only.isdisjoint(jax_defaults)
    cfg = parse_config(["--buckets", "4,8", "--mask_padding", "false", "--batch_size", "3",
                        "--device", "cpu"])
    assert (cfg.buckets, cfg.mask_padding, cfg.batch_size, cfg.device) == ((4, 8), False, 3, "cpu")
