"""K5's plain PyTorch version against the JAX TPU kernel, on the CPU.

``sepconv_unit_pallas`` runs in interpret mode at tests/test_pallas_sepconv.py's
shape and ``row_tile=4`` (odd H and W leave a partial last stripe), with every
ReLU combination, and at a 1x1 image (the exit flow of a 32^2 input). The JAX
kernel multiplies by ``pw`` in the dtype it is given: both sides get
bf16-representable weights, so the pointwise products are exact on both.
Both sides round at the same points: the bound is rtol = atol = 1.6e-2 (two
bf16 ulps at unit scale), as for K1 and K3.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_unit import (  # noqa: E402
    pack_unit as jax_pack_unit,
)
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_unit import (  # noqa: E402
    sepconv_unit_pallas,
)
from multimodal_deepfake_detection_tpu_torch.ops.kernels.sepconv_unit import (  # noqa: E402
    pack_unit,
    sepconv_unit,
    sepconv_unit_ref,
)

BF16_TOL = 1.6e-2


def _case(B, H, W, Cin, Cout, dtype, seed):
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(rng.standard_normal((B, H, W, Cin)), jdt)
    dw = (rng.standard_normal((9, Cin)) * 0.2).astype(np.float32)
    pw = np.array(jnp.asarray(rng.standard_normal((Cin, Cout)) * 0.1, jnp.bfloat16)
                  .astype(jnp.float32))
    b = (rng.standard_normal(Cout) * 0.05).astype(np.float32)
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    rows = torch.full((Cout, Cin + 32), float("nan"))  # NaN the kernel must not read
    rows[:, :Cin] = torch.from_numpy(pw.T)
    port = (x, torch.from_numpy(dw), rows.to(torch.bfloat16), torch.from_numpy(b))
    return (xj, jnp.asarray(dw), jnp.asarray(pw), jnp.asarray(b)), port


@pytest.mark.parametrize("shape,lead,trail,dtype", [
    ((2, 9, 7, 8, 16), False, False, "float32"), ((2, 9, 7, 8, 16), False, True, "float32"),
    ((2, 9, 7, 8, 16), True, False, "float32"), ((2, 9, 7, 8, 16), True, True, "float32"),
    ((2, 9, 7, 8, 16), False, True, "bfloat16"), ((2, 9, 7, 8, 16), True, True, "bfloat16"),
    ((3, 1, 1, 16, 24), False, True, "bfloat16"), ((3, 1, 1, 16, 24), True, False, "float32"),
])
def test_ref_matches_jax_unit(shape, lead, trail, dtype):
    jx, port = _case(*shape, dtype, seed=sum(shape) + 2 * lead + trail)
    kw = dict(leading_relu=lead, trailing_relu=trail)
    got = sepconv_unit(*port, **kw)
    B, H, W, _, Cout = shape
    assert got.dtype == port[0].dtype and tuple(got.shape) == (B, H, W, Cout)
    ref = sepconv_unit_pallas(*jx, **kw, row_tile=4, interpret=True)
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    print(f"{shape} lead={lead} trail={trail} {dtype}: max|d|={np.abs(got - ref).max():.3e} "
          f"bit-equal share={np.mean(got == ref):.4f}")
    np.testing.assert_allclose(got, ref, rtol=BF16_TOL, atol=BF16_TOL)
    if trail:
        assert (got >= 0).all()


def test_relu_switches_change_the_result():
    """The control of the test above: each switch moves the plain output."""
    _, port = _case(2, 9, 7, 8, 16, "float32", seed=3)
    outs = [sepconv_unit_ref(*port, leading_relu=lead, trailing_relu=trail)
            for lead in (False, True) for trail in (False, True)]
    for i in range(4):
        for j in range(i):
            assert (outs[i] - outs[j]).abs().max().item() > 1e-2


def test_pack_unit_matches_jax_pack_unit():
    rng = np.random.default_rng(4)
    Cin, Cout = 40, 24
    dw = rng.standard_normal((Cin, 1, 3, 3)).astype(np.float32)
    pw = rng.standard_normal((Cout, Cin, 1, 1)).astype(np.float32)
    b = rng.standard_normal(Cout).astype(np.float32)
    got = pack_unit(*map(torch.from_numpy, (dw, pw, b)))
    want = jax_pack_unit({"depthwise": {"w": jnp.asarray(dw.transpose(2, 3, 1, 0))},
                          "pointwise": {"w": jnp.asarray(pw.transpose(2, 3, 1, 0)),
                                        "b": jnp.asarray(b)}})
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # bf16 [out, in] here, fp32 [in, out] in JAX; rows padded 40 -> 64
    assert got[1].dtype == torch.bfloat16 and tuple(got[1].shape) == (Cout, 64)
    np.testing.assert_array_equal(got[1][:, :Cin].float().numpy(),
                                  np.asarray(want[1].astype(jnp.bfloat16).astype(jnp.float32)).T)
    assert not got[1][:, Cin:].any()
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert all(t.is_contiguous() for t in got)
