"""K1's plain PyTorch version against the JAX TPU kernel, on the CPU.

``middle_block_pos_pallas`` runs in interpret mode, as tests/test_pallas_pos.py
runs it. Both sides round at the same points, so near bit-equality is
expected; the bound is rtol = atol = 1.6e-2 (two bf16 ulps at unit scale) to
allow an fp32 summation-order flip before a bf16 cast.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_block import (  # noqa: E402
    pack_middle_block as jax_pack_middle_block,
)
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_pos import (  # noqa: E402
    from_pos_layout,
    middle_block_pos_pallas,
    to_pos_layout,
)
from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block import (  # noqa: E402
    middle_block,
    middle_block_ref,
    pack_middle_block,
)

BF16_TOL = 1.6e-2


def _operands(rng, C, reps=3):
    dw = rng.normal(0, 0.2, (reps, 9, C)).astype(np.float32)
    pw = rng.normal(0, 0.08, (reps, C, C)).astype(np.float32)
    b = rng.normal(0, 0.1, (reps, C)).astype(np.float32)
    return dw, pw, b


@pytest.mark.parametrize(
    "B,H,W,C,dtype",
    [(4, 8, 8, 128, "bfloat16"), (3, 4, 4, 128, "bfloat16"), (3, 4, 4, 128, "float32")],
)
def test_ref_matches_jax_pos_kernel(B, H, W, C, dtype):
    rng = np.random.default_rng(B * 100 + H)
    x32 = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    dw, pw, b = _operands(rng, C)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x32, jdt)
    ref = from_pos_layout(
        middle_block_pos_pallas(to_pos_layout(xj), jnp.asarray(dw), jnp.asarray(pw),
                                jnp.asarray(b), interpret=True, batch_tile=8, pos_chunks=4),
        H, W,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    # rows padded as pack_middle_block pads them, with NaN the kernel must not read
    pw_out_in = torch.full((3, C, C + 32), float("nan"))
    pw_out_in[..., :C] = torch.from_numpy(pw.transpose(0, 2, 1))
    got = middle_block(x, torch.from_numpy(dw), pw_out_in.to(torch.bfloat16), torch.from_numpy(b))
    assert got.dtype == x.dtype and tuple(got.shape) == (B, H, W, C)
    got = got.float().numpy()
    diff = np.abs(got - ref)
    print(f"max|d|={diff.max():.3e} bit-equal share={np.mean(got == ref):.4f}")
    np.testing.assert_allclose(got, ref, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("H", [2, 1])
def test_ref_exact_on_degenerate_trunks(H):
    """2x2 and 1x1 trunks (32^2 and smaller inputs): every tap but the centre
    (and the in-range neighbours) reads the zero halo. Checked against a
    direct numpy evaluation of the same rounding points."""
    rng = np.random.default_rng(7 + H)
    B, C = 3, 16
    x = torch.from_numpy(rng.normal(0, 1, (B, H, H, C)).astype(np.float32)).to(torch.bfloat16)
    dw, pw, b = _operands(rng, C)
    pw16 = torch.from_numpy(pw).to(torch.bfloat16)
    got = middle_block_ref(x, torch.from_numpy(dw), pw16, torch.from_numpy(b)).float().numpy()

    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()
    h = x.float().numpy()
    for r in range(3):
        ap = np.pad(bf(np.maximum(h, 0)), ((0, 0), (1, 1), (1, 1), (0, 0)))
        acc = sum(ap[:, dy:dy + H, dx:dx + H] * dw[r, dy * 3 + dx]
                  for dy in range(3) for dx in range(3))
        o = bf(acc) @ pw16[r].float().numpy().T + b[r]
        if r == 2:
            o = o + x.float().numpy()
        h = bf(o)
    np.testing.assert_allclose(got, h, rtol=BF16_TOL, atol=BF16_TOL)


def test_pack_matches_jax_pack():
    rng = np.random.default_rng(8)
    C = 24
    units_t, units_j = [], []
    for _ in range(3):
        dw = rng.normal(size=(C, 1, 3, 3)).astype(np.float32)
        pw = rng.normal(size=(C, C, 1, 1)).astype(np.float32)
        b = rng.normal(size=(C,)).astype(np.float32)
        units_t.append(tuple(map(torch.from_numpy, (dw, pw, b))))
        units_j.append({"depthwise": {"w": jnp.asarray(dw.transpose(2, 3, 1, 0))},
                        "pointwise": {"w": jnp.asarray(pw.transpose(2, 3, 1, 0)),
                                      "b": jnp.asarray(b)}})
    dw_t, pw_t, b_t = pack_middle_block(units_t)
    dw_j, pw_j, b_j = jax_pack_middle_block({"units": units_j})
    np.testing.assert_array_equal(dw_t.numpy(), np.asarray(dw_j))
    assert tuple(pw_t.shape) == (3, C, 32)  # rows padded to 64 bytes
    np.testing.assert_array_equal(  # [out, in] here, [in, out] in JAX
        pw_t[..., :C].float().numpy(),
        np.asarray(pw_j.astype(jnp.bfloat16).astype(jnp.float32)).transpose(0, 2, 1))
    assert not pw_t[..., C:].any()
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    assert pw_t.dtype == torch.bfloat16 and pw_t.is_contiguous()
