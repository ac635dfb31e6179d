"""K3's plain PyTorch version against the JAX TPU kernels, and the fused-entry
backbone against the JAX fused route, on the CPU.

``entry_block_pallas`` and ``entry_block_striped_pallas`` run in interpret
mode, as tests/test_pallas_sepconv.py runs them. Both sides round at the same
points, so only fp32 summation order (and XLA-CPU's FMA contraction of the
depthwise products) can flip a bf16 rounding: the op bound is rtol = atol =
1.6e-2 (two bf16 ulps at unit scale). The 64^2 backbone compounds such flips
over 12 blocks; its feature bound is stated at the test.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.models.fold import (  # noqa: E402
    fold_xception_bn as jax_fold_xception_bn,
)
from multimodal_deepfake_detection_tpu.models.fold import folded_xception_apply  # noqa: E402
from multimodal_deepfake_detection_tpu.models.xception import xception_init  # noqa: E402
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_entry import (  # noqa: E402
    entry_block as jax_entry_block,
)
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_entry import (  # noqa: E402
    pack_entry_block as jax_pack_entry_block,
)
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_entry_striped import (  # noqa: E402
    entry_block_striped as jax_entry_block_striped,
)
from multimodal_deepfake_detection_tpu_torch.cli import serve as tcli  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models import fold as tfold  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models.heads import (  # noqa: E402
    ArcFace,
    XceptionLSTM,
)
from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_block import (  # noqa: E402
    entry_block,
    entry_block_ref,
    pack_entry_block,
)
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

BF16_TOL = 1.6e-2


def _operands(rng, Cin, Cmid, Cout):
    """JAX-layout K3 weights: taps (9, C), pointwise and skip [in, out], fp32."""
    f = lambda *shape, s: rng.standard_normal(shape).astype(np.float32) * s
    return (f(9, Cin, s=0.1), f(Cin, Cmid, s=0.02), f(Cmid, s=0.01), f(9, Cmid, s=0.1),
            f(Cmid, Cout, s=0.02), f(Cout, s=0.01), f(Cin, Cout, s=0.02), f(Cout, s=0.01))


def _port_operands(ops):
    """JAX-layout weights -> the port's: [out, in] bf16 rows padded by 32
    columns of NaN, which neither the kernel nor its plain version may read."""
    def rows(w):
        out = torch.full((w.shape[1], w.shape[0] + 32), float("nan"))
        out[:, : w.shape[0]] = torch.from_numpy(w.T)
        return out.to(torch.bfloat16)
    dw0, pw0, b0, dw1, pw1, b1, skw, skb = ops
    t = torch.from_numpy
    return t(dw0), rows(pw0), t(b0), t(dw1), rows(pw1), t(b1), rows(skw), t(skb)


def _check(got, ref, label):
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    diff = np.abs(got - ref)
    print(f"{label}: max|d|={diff.max():.3e} bit-equal share={np.mean(got == ref):.4f}")
    np.testing.assert_allclose(got, ref, rtol=BF16_TOL, atol=BF16_TOL, err_msg=label)


@pytest.mark.parametrize(
    "H,Cin,Cmid,Cout,lead,dtype",
    [(12, 64, 128, 128, False, "bfloat16"), (13, 128, 256, 256, True, "bfloat16"),
     (10, 16, 40, 40, True, "bfloat16"), (9, 40, 16, 32, False, "bfloat16"),
     (10, 16, 40, 40, True, "float32")],
)
def test_ref_matches_jax_entry_block(H, Cin, Cmid, Cout, lead, dtype):
    """The whole-image kernel at tests/test_pallas_sepconv.py's shapes: odd
    and even H, Cmid != Cout, channels off the 128-lane tile; one fp32 case."""
    rng = np.random.default_rng(H * 10 + Cin)
    B = 2
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(rng.standard_normal((B, H, H, Cin)) * 0.5, jdt)
    ops = _operands(rng, Cin, Cmid, Cout)
    ref = jax_entry_block(xj, *map(jnp.asarray, ops), leading_relu0=lead, row_chunk=96,
                          interpret=True)
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = entry_block(x, *_port_operands(ops), leading_relu0=lead)
    Hp = (H + 1) // 2
    assert got.dtype == x.dtype and tuple(got.shape) == (B, Hp, Hp, Cout)
    _check(got, ref.astype(jnp.float32), f"H={H} {Cin}->{Cmid}->{Cout} {dtype}")


@pytest.mark.parametrize(
    "H,Cin,Cmid,Cout,lead,SH",
    [(15, 8, 16, 16, False, 5), (12, 8, 8, 24, True, 4), (9, 16, 8, 16, True, 3)],
)
def test_ref_matches_jax_striped_entry_block(H, Cin, Cmid, Cout, lead, SH):
    """The striped kernel (block 1's route) at its test's shapes and stripe
    heights: the pool carried across stripes, ragged pooled rows."""
    rng = np.random.default_rng(100 + H)
    B = 2
    xj = jnp.asarray(rng.standard_normal((B, H, H, Cin)) * 0.5, jnp.bfloat16)
    ops = _operands(rng, Cin, Cmid, Cout)
    ref = jax_entry_block_striped(xj, *map(jnp.asarray, ops), leading_relu0=lead,
                                  stripe_rows=SH, row_chunk=96, interpret=True)
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    _check(entry_block(x, *_port_operands(ops), leading_relu0=lead),
           ref.astype(jnp.float32), f"striped H={H} SH={SH}")


@pytest.mark.parametrize("H,W,lead,striped", [(3, 521, True, False), (4, 514, False, True)])
def test_ref_matches_jax_at_widths_past_512(H, W, lead, striped):
    """One short image wider than the first design's depthwise band took
    (512): the whole-image kernel, and the striped one in 2-row stripes."""
    rng = np.random.default_rng(W)
    Cin, Cmid, Cout = 8, 16, 8
    xj = jnp.asarray(rng.standard_normal((1, H, W, Cin)) * 0.5, jnp.bfloat16)
    ops = _operands(rng, Cin, Cmid, Cout)
    jops = map(jnp.asarray, ops)
    if striped:
        ref = jax_entry_block_striped(xj, *jops, leading_relu0=lead, stripe_rows=2, row_chunk=96,
                                      interpret=True)
    else:
        ref = jax_entry_block(xj, *jops, leading_relu0=lead, row_chunk=96, interpret=True)
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = entry_block(x, *_port_operands(ops), leading_relu0=lead)
    assert tuple(got.shape) == (1, (H + 1) // 2, (W + 1) // 2, Cout)
    _check(got, ref.astype(jnp.float32), f"W={W} striped={striped}")


@pytest.mark.parametrize("H", [1, 2])
def test_ref_on_tiny_images(H):
    """1x1 and 2x2 inputs (the exit flow of tiny frames): most taps and pool
    windows read padding. Checked against a direct numpy evaluation of the
    same rounding points."""
    rng = np.random.default_rng(7 + H)
    B, Cin, Cmid, Cout = 3, 16, 24, 8
    ops = _operands(rng, Cin, Cmid, Cout)
    dw0, pw0, b0, dw1, pw1, b1, skw, skb = ops
    x = torch.from_numpy(rng.standard_normal((B, H, H, Cin)).astype(np.float32)).to(torch.bfloat16)
    got = entry_block_ref(x, *_port_operands(ops), leading_relu0=True).float().numpy()

    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()

    def dw(a, taps):
        ap = np.pad(a, ((0, 0), (1, 1), (1, 1), (0, 0)))
        cols = [sum(ap[:, dy:dy + H, dx:dx + H] * taps[dy * 3 + dx] for dy in range(3))
                for dx in range(3)]
        return bf((cols[0] + cols[1]) + cols[2])

    xb = x.float().numpy()
    mid = bf(np.maximum(dw(np.maximum(xb, 0), dw0) @ bf(pw0) + b0, 0))
    outs = bf(dw(mid, dw1) @ bf(pw1) + b1)
    Hp = (H + 1) // 2
    pooled = np.stack([np.stack([outs[:, max(2 * q - 1, 0):2 * q + 2, max(2 * j - 1, 0):2 * j + 2]
                                 .max(axis=(1, 2)) for j in range(Hp)], 1) for q in range(Hp)], 1)
    want = pooled + (xb[:, ::2, ::2] @ bf(skw) + skb)
    np.testing.assert_allclose(got, bf(want), rtol=BF16_TOL, atol=BF16_TOL)


def test_pack_matches_jax_pack():
    rng = np.random.default_rng(8)
    Cin, Cmid, Cout = 24, 40, 48
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    units_t, units_j = [], []
    for ci, co in ((Cin, Cmid), (Cmid, Cout)):
        dw, pw, b = f(ci, 1, 3, 3), f(co, ci, 1, 1), f(co)
        units_t.append(tuple(map(torch.from_numpy, (dw, pw, b))))
        units_j.append({"depthwise": {"w": jnp.asarray(dw.transpose(2, 3, 1, 0))},
                        "pointwise": {"w": jnp.asarray(pw.transpose(2, 3, 1, 0)),
                                      "b": jnp.asarray(b)}})
    skw, skb = f(Cout, Cin, 1, 1), f(Cout)
    got = pack_entry_block(units_t, (torch.from_numpy(skw), torch.from_numpy(skb)))
    want = jax_pack_entry_block({"units": units_j, "skip": {"w": jnp.asarray(
        skw.transpose(2, 3, 1, 0)), "b": jnp.asarray(skb)}})
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.is_contiguous()
        if i in (1, 4, 6):  # bf16 [out, in] here, fp32 [in, out] in JAX; rows padded to 32
            K = w.shape[0]
            assert g.dtype == torch.bfloat16 and g.shape[1] == -(-K // 32) * 32
            np.testing.assert_array_equal(
                g[:, :K].float().numpy(), np.asarray(w.astype(jnp.bfloat16).astype(jnp.float32)).T)
            assert not g[:, K:].any()
        else:
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _randomize_bn(params, state, rng):
    """Random running stats and affine params on every BN, in place."""
    if isinstance(state, dict) and "mean" in state:
        n = state["mean"].shape
        state["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
        state["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        params["scale"] = rng.uniform(0.8, 1.2, n).astype(np.float32)
        params["bias"] = rng.normal(0, 0.05, n).astype(np.float32)
    elif isinstance(state, dict):
        for k in state:
            _randomize_bn(params[k], state[k], rng)
    elif isinstance(state, list):
        for p, s in zip(params, state):
            _randomize_bn(p, s, rng)


# Feature bound of the 64^2 backbone: both sides round at the same points,
# and a CPU run of this test reads max|d| 5.1e-7 at features up to 0.40 (an
# fp32 summation-order flip before a bf16 cast carries through the later
# blocks). atol 2e-5 keeps a 40x margin over that reading.
SLICE_TOL = dict(rtol=1e-4, atol=2e-5)


def test_fused_entry_backbone_matches_jax_fused_route(monkeypatch):
    """The 64^2 backbone (stride-2 blocks at H = 29, 15, 8, 4) with every
    stride-2 block fused and the middle flow through K1, against the JAX
    ``use_pallas=True`` route with MDFD_ENTRY_FUSE_H naming those heights,
    fp32 activations, Pallas in interpret mode. Weights cross through the
    weight bridge."""
    params, state = xception_init(jax.random.PRNGKey(3), num_classes=None)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    _randomize_bn(params, state, np.random.default_rng(0))
    x = np.random.default_rng(1).random((2, 64, 64, 3), np.float32)

    monkeypatch.setenv("MDFD_ENTRY_FUSE_H", "29,15,8,4")
    ref = folded_xception_apply(jax_fold_xception_bn(params, state), jnp.asarray(x),
                                features_only=True, use_pallas=True, pallas_interpret=True)

    calls = []
    monkeypatch.setattr(tfold, "entry_block", lambda *a, **k: calls.append(1) or entry_block(*a, **k))
    folded = tfold.fold_xception_bn(jax_weights.xception_from_jax(params, state))
    with torch.no_grad():
        got = folded(torch.from_numpy(x), features_only=True, use_kernels=True, fuse_entry=True)
    assert len(calls) == 4 and [k for k, b in enumerate(folded.blocks) if b.is_entry] == [0, 1, 2, 11]
    ref = np.asarray(ref)
    print(f"features max|d|={np.abs(got.numpy() - ref).max():.3e} (max|ref|={np.abs(ref).max():.3e})")
    np.testing.assert_allclose(got.numpy(), ref, **SLICE_TOL)


def test_fuse_entry_with_quantize_raises():
    """The JAX w8a8 walk never routes K3, so the port refuses the pair."""
    g = torch.Generator().manual_seed(0)
    model, arc = XceptionLSTM(8, generator=g), ArcFace(8, 2, generator=g)
    with pytest.raises(ValueError, match="fuse_entry"):
        VisualScorer(model, arc, quantize="w8a8", fuse_entry=True, device="cpu")


def test_cli_fuse_entry_flag():
    assert tcli.parse_config([]).fuse_entry is False
    assert tcli.parse_config(["--fuse_entry", "true"]).fuse_entry is True
