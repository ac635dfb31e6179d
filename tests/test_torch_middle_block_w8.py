"""K2's plain PyTorch version against the JAX TPU kernel, on the CPU.

``middle_block_pos_pallas_w8`` runs in interpret mode, as
tests/test_pallas_pos.py runs it. Both sides round at the same points (bf16
ReLU pad, fp32 taps pre-divided by ``s_in``, round-half-even int8, exact
integer product, fp32 epilogue), so the outputs should be bit-equal; the
bound is >= 99.9 % of elements bit-equal and the rest within
tests/test_pallas_pos.py:124-125's bound (a +-1 flip of an int8 code after
an fp32 summation-order difference). With fp32 I/O "equal" means within two
fp32 ulps of the largest output: XLA on the CPU contracts the epilogue's ``y * sc + b`` into one
fused multiply-add (measured: a jitted ``a*b+c`` equals the FMA on every
element), while the port rounds the product and the sum separately, as the
CUDA kernel must to match its plain version bit for bit; the ulp is the
terms', and where they cancel it exceeds the result's own ulp. In bf16 the
output rounding hides it.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_pos import (  # noqa: E402
    from_pos_layout,
    middle_block_pos_pallas_w8,
    to_pos_layout,
)
from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block_w8 import (  # noqa: E402
    middle_block_w8,
    middle_block_w8_ref,
)


def _operands(rng, C, reps=3):
    dw = rng.normal(0, 0.2, (reps, 9, C)).astype(np.float32)
    pw = rng.normal(0, 0.08, (reps, C, C)).astype(np.float32)  # [in, out], as JAX packs it
    b = rng.normal(0, 0.1, (reps, C)).astype(np.float32)
    s_w = (np.abs(pw).max(axis=1) / 127.0).astype(np.float32)
    pw_q = np.clip(np.round(pw / s_w[:, None, :]), -127, 127).astype(np.int8)
    s_dq = np.full((reps,), 2.5 / 127.0, np.float32)
    s_in = (s_dq[:, None] * rng.uniform(0.5, 2.0, (reps, C))).astype(np.float32)
    return dw, pw_q, s_w, s_in, s_dq, b


@pytest.mark.parametrize(
    "B,H,C,dtype",
    [(3, 4, 128, "bfloat16"), (2, 2, 128, "bfloat16"), (1, 1, 64, "bfloat16"),
     (3, 4, 128, "float32")],
)
def test_ref_matches_jax_pos_w8_kernel(B, H, C, dtype):
    rng = np.random.default_rng(B * 100 + H * 10 + C)
    dw, pw_q, s_w, s_in, s_dq, b = _operands(rng, C)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(rng.normal(0, 1, (B, H, H, C)), jdt)
    ref = from_pos_layout(
        middle_block_pos_pallas_w8(to_pos_layout(xj), *map(jnp.asarray, (dw, pw_q, s_w, s_in, s_dq, b)),
                                   interpret=True),
        H, H,
    )
    ref = np.asarray(ref.astype(jnp.float32))

    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    # [out, in] rows padded to 64 bytes, with garbage the kernel must not read
    pw_t = torch.from_numpy(rng.integers(-128, 128, (3, C, C + 64), dtype=np.int8))
    pw_t[..., :C] = torch.from_numpy(pw_q.transpose(0, 2, 1).copy())
    got = middle_block_w8(x, *map(torch.from_numpy, (dw,)), pw_t,
                          *map(torch.from_numpy, (s_w, s_in, s_dq, b)))
    assert got.dtype == x.dtype and tuple(got.shape) == (B, H, H, C)
    got = got.float().numpy()
    diff = np.abs(got - ref)
    ulps = 0 if dtype == "bfloat16" else 2 * np.spacing(np.abs(ref).max())
    equal = np.mean(diff <= ulps)
    print(f"max|d|={diff.max():.3e} bit-equal share={np.mean(got == ref):.6f} "
          f"within the bound's ulps={equal:.6f}")
    assert equal >= 0.999
    lsb = float((s_in[:, None] * s_w).max() * C)
    np.testing.assert_allclose(got, ref, atol=lsb * 0.05 + 0.05, rtol=0.02)


def test_ref_takes_the_plain_version_on_cpu():
    """The wrapper on a CPU tensor is the plain version, bit for bit."""
    rng = np.random.default_rng(5)
    C = 16
    dw, pw_q, s_w, s_in, s_dq, b = map(torch.from_numpy, _operands(rng, C))
    pw_t = pw_q.transpose(1, 2).contiguous()
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 3, C)).astype(np.float32)).to(torch.bfloat16)
    before = middle_block_w8.launches
    got = middle_block_w8(x, dw, pw_t, s_w, s_in, s_dq, b)
    assert torch.equal(got, middle_block_w8_ref(x, dw, pw_t, s_w, s_in, s_dq, b))
    assert middle_block_w8.launches == before
