"""Train-mode batch norm and the loss zoo against the JAX package, on the CPU.

Batch norm: the port's ``batch_norm_train`` + ``BatchNorm.update`` against
JAX ``batch_norm(train=True)`` (its default custom-VJP path), outputs, new
running statistics and the gradients of ``x``, scale and bias under a fixed
cotangent, at odd N and C, fp32 and bf16 inputs. fp32 bars: outputs and
statistics rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5 (JAX's
hand-written backward against autograd through the formula: the same
function, summed in another order). bf16 input: the output within one bf16
ulp at its scale (rtol = atol = 7.9e-3), the fp32 statistics and gradients
at the fp32 bars.

Losses: every loss's value and its gradient with respect to its inputs,
fp32, rtol 1e-5 / atol 1e-6 (values) and rtol 1e-5 / atol 1e-7 (gradients;
the BCE's saturated gradients, about 1e12, by rtol alone); ``bce_loss`` at
p in {0, 1} finite in value and gradient, and its target gradient within the
deliberate +-200 clamp.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_deepfake_detection_tpu.models import losses as jl
from multimodal_deepfake_detection_tpu.ops.conv import batch_norm as jax_batch_norm
from multimodal_deepfake_detection_tpu_torch.models import losses as tl
from multimodal_deepfake_detection_tpu_torch.ops.conv import BatchNorm, batch_norm_train

F32 = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,dtype", [((5, 3, 3, 7), "float32"), ((3, 5, 1, 13), "float32"),
                                         ((5, 3, 3, 7), "bfloat16")])
def test_batch_norm_train_matches_jax(shape, dtype):
    rng = np.random.default_rng(0)
    C = shape[-1]
    x = (rng.normal(0.7, 1.3, shape)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, C).astype(np.float32), rng.normal(0, 0.3, C).astype(np.float32)
    mean0, var0 = rng.normal(0, 0.2, C).astype(np.float32), rng.uniform(0.5, 2, C).astype(np.float32)
    cot = rng.normal(0, 1, shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jloss(x, scale, bias):
        out, st = jax_batch_norm({"scale": scale, "bias": bias},
                                 {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)},
                                 x, train=True)
        return jnp.sum(out.astype(jnp.float32) * cot), (out, st)

    (_, (j_out, j_st)), j_grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                                          has_aux=True))(
        jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias))

    bn = BatchNorm(C)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(mean0))
        bn.var.copy_(torch.from_numpy(var0))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    t_out, (mean, var) = bn.train_forward(tx)
    assert t_out.dtype == tdt and not mean.requires_grad and not var.requires_grad
    (t_out.float() * torch.from_numpy(cot)).sum().backward()
    bn.update(mean, var)

    out_tol = F32 if dtype == "float32" else dict(rtol=7.9e-3, atol=7.9e-3)
    np.testing.assert_allclose(t_out.detach().float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)), **out_tol)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(j_st["mean"]), **F32)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(j_st["var"]), **F32)
    for got, want in zip((tx.grad, bn.scale.grad, bn.bias.grad), j_grads):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   **GRAD)
    # functional form: the same output, and the unbiased variance n/(n-1)
    o2, m2, v2 = batch_norm_train(tx.detach(), bn.scale.detach(), bn.bias.detach())
    n = x.size // C
    xf = tx.detach().float().reshape(-1, C)
    assert torch.equal(m2, xf.mean(0))
    np.testing.assert_allclose(v2.numpy(), xf.var(0, unbiased=True).numpy(), rtol=1e-4)
    assert v2.shape == (C,) and n > 1


def _inputs(seed=0, n=7):
    rng = np.random.default_rng(seed)
    logits2 = rng.normal(0, 3, (n, 2)).astype(np.float32)
    logits1 = rng.normal(0, 3, (n,)).astype(np.float32)
    labels = rng.integers(0, 2, n)
    probs = rng.uniform(0.02, 0.98, (n,)).astype(np.float32)
    sw = (rng.uniform(0, 1, n) > 0.3).astype(np.float32)
    tokens = rng.normal(0, 1, (2, 5, 3)).astype(np.float32)
    return logits2, logits1, labels, probs, sw, tokens


CW = np.array([0.3, 1.7], np.float32)
CASES = {
    "bce": (lambda m, p, t, sw: m.bce_loss(p, t), "probs"),
    "bce_weighted": (lambda m, p, t, sw: m.bce_loss(p, t, sample_weight=sw), "probs"),
    "bce_with_logits": (lambda m, z, t, sw: m.bce_with_logits_loss(z, t, sample_weight=sw), "logits1"),
    "label_smoothing": (lambda m, z, t, sw: m.label_smoothing_bce_loss(z, t, 0.1), "logits1"),
    "focal": (lambda m, z, t, sw: m.focal_bce_loss(z, t, sample_weight=sw), "logits1"),
    "clamp_then_bce": (lambda m, z, t, sw: m.bce_with_logits_loss(m.clamp_logits(z * 5, 4.0), t),
                       "logits1"),
    "cross_entropy": (lambda m, z, y, sw: m.cross_entropy_loss(z, y), "logits2"),
    "cross_entropy_weighted": (lambda m, z, y, sw: m.cross_entropy_loss(
        z, y, class_weights=m_arr(m, CW), sample_weight=sw), "logits2"),
    "cb_focal": (lambda m, z, y, sw: m.cb_focal_loss(
        z, y, m.cb_focal_class_weights([30, 7], beta=0.99), sample_weight=sw), "logits2"),
    "align_mse": (lambda m, a, y, sw: m.align_mse_loss(a[:, :1], a[:, 1:] * 0.5), "logits2"),
    "temporal_smoothness": (lambda m, tok, y, sw: m.temporal_smoothness_loss(tok), "tokens"),
}


def m_arr(m, a):
    return torch.from_numpy(a) if m is tl else jnp.asarray(a)


def _pair(name):
    logits2, logits1, labels, probs, sw, tokens = _inputs()
    x = {"probs": probs, "logits1": logits1, "logits2": logits2, "tokens": tokens}[CASES[name][1]]
    y = labels if CASES[name][1] in ("logits2", "tokens") else labels.astype(np.float32)
    return x, y, sw


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_value_and_grad_match_jax(name):
    fn, _ = CASES[name]
    x, y, sw = _pair(name)
    j_val, j_grad = jax.jit(jax.value_and_grad(lambda a, y, sw: fn(jl, a, y, sw)))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(sw))
    tx = torch.from_numpy(x.copy()).requires_grad_()
    t_val = fn(tl, tx, torch.from_numpy(y), torch.from_numpy(sw))
    t_val.backward()
    np.testing.assert_allclose(t_val.item(), float(j_val), **F32)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_grad), rtol=1e-5, atol=1e-7)


def test_adaptive_mixer_matches_jax():
    mix_t = tl.adaptive_loss_init()
    parts = (torch.tensor(0.7), torch.tensor(0.2, requires_grad=True), torch.tensor(1.3))
    total = tl.adaptive_deepfake_loss(mix_t, *parts)
    total.backward()
    j_total, j_grads = jax.value_and_grad(
        lambda mp: jl.adaptive_deepfake_loss(mp, 0.7, 0.2, 1.3))(jl.adaptive_loss_init())
    np.testing.assert_allclose(total.item(), float(j_total), **F32)
    for k in ("alpha", "beta"):
        np.testing.assert_allclose(mix_t[k].grad.item(), float(j_grads[k]), **F32)
    np.testing.assert_allclose(tl.cb_focal_class_weights([30, 7]).numpy(),
                               np.asarray(jl.cb_focal_class_weights([30, 7])), **F32)


def test_bce_saturated_probs_are_finite_and_match_jax():
    p = np.array([0.0, 1.0, 0.0, 1.0, 0.5], np.float32)
    t = np.array([1.0, 0.0, 0.0, 1.0, 1.0], np.float32)
    (j_val, (j_dp, j_dt)) = jax.value_and_grad(jl.bce_loss, argnums=(0, 1))(
        jnp.asarray(p), jnp.asarray(t))
    tp = torch.from_numpy(p.copy()).requires_grad_()
    tt = torch.from_numpy(t.copy()).requires_grad_()
    val = tl.bce_loss(tp, tt)
    val.backward()
    for got in (val, tp.grad, tt.grad):
        assert torch.isfinite(got).all()
    np.testing.assert_allclose(val.item(), float(j_val), **F32)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(j_dp), rtol=1e-6)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(j_dt), rtol=1e-6, atol=1e-7)
    # the target cotangent's clamp: +-100 per element here, within +-200 always
    assert np.abs(tt.grad.numpy() * len(p)).max() <= 200
    np.testing.assert_allclose(tt.grad.numpy()[:2] * len(p), [100.0, -100.0])
