"""K1's plain PyTorch version against the image-major JAX middle blocks, on
the CPU: ``middle_block_pallas`` (v1) and ``middle_block_pallas_v2`` with
``precise=True`` compute K1's function, and ``precise=False`` is K1 with
``taps="bf16"``.

The Pallas kernels run in interpret mode, as tests/test_pallas_sepconv.py
runs them. Bounds as tests/test_torch_middle_block.py sets them: rtol = atol
= 1.6e-2 (two bf16 ulps at unit scale), which allows an fp32 summation-order
flip of the pointwise before a bf16 cast. Before the pointwise, the bf16 tap
chain is bit-equal to XLA's (``test_bf16_tap_depthwise_is_bit_equal_to_xla``).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_block import (  # noqa: E402
    middle_block_pallas,
    middle_block_pallas_v2,
)
from multimodal_deepfake_detection_tpu_torch.ops.kernels._plain import (  # noqa: E402
    depthwise3x3_ref,
)
from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block import (  # noqa: E402
    middle_block,
    middle_block_ref,
)

BF16_TOL = 1.6e-2
SHAPES = [(3, 8, 8, 16), (3, 4, 4, 40), (2, 2, 2, 16), (1, 1, 1, 16)]


def _case(B, H, W, C, dtype, seed):
    """Seeded x (in ``dtype``) and JAX-layout weights; the port's pointwise
    rows ``[out, in]`` padded by 32 columns of NaN, which neither the kernel
    nor its plain version may read."""
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(rng.normal(0, 1, (B, H, W, C)), jdt)
    dw = rng.normal(0, 0.2, (3, 9, C)).astype(np.float32)
    pw = rng.normal(0, 0.1, (3, C, C)).astype(np.float32)
    b = rng.normal(0, 0.05, (3, C)).astype(np.float32)
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    pw_t = torch.full((3, C, C + 32), float("nan"))
    pw_t[..., :C] = torch.from_numpy(pw.transpose(0, 2, 1))
    port = (x, torch.from_numpy(dw), pw_t.to(torch.bfloat16), torch.from_numpy(b))
    return (xj, jnp.asarray(dw), jnp.asarray(pw), jnp.asarray(b)), port


def _check(got, ref, label):
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    equal = np.mean(got == ref)
    print(f"{label}: max|d|={np.abs(got - ref).max():.3e} bit-equal share={equal:.4f}")
    np.testing.assert_allclose(got, ref, rtol=BF16_TOL, atol=BF16_TOL, err_msg=label)
    return equal


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_ref_matches_jax_v1(shape, dtype):
    """v1 keeps h in fp32 between reps and rounds it to bf16 before the taps:
    K1's function at either I/O dtype."""
    jx, port = _case(*shape, dtype, seed=sum(shape))
    got = middle_block(*port)
    assert got.dtype == port[0].dtype and tuple(got.shape) == shape
    _check(got, middle_block_pallas(*jx, interpret=True), f"v1 {shape} {dtype}")


# every (images_per_step, per_image_dot) at each dtype, each shape at both dtypes
SCHEDULES = [(1, False), (4, False), (1, True), (4, True)]
V2_CASES = [(shape, dtype, *SCHEDULES[(2 * i + j) % 4])
            for i, shape in enumerate(SHAPES) for j, dtype in enumerate(["bfloat16", "float32"])]


@pytest.mark.parametrize("shape,dtype,ips,per_image_dot", V2_CASES)
def test_ref_matches_jax_v2_precise(shape, dtype, ips, per_image_dot):
    """``images_per_step`` and ``per_image_dot`` change only v2's schedule."""
    jx, port = _case(*shape, dtype, seed=sum(shape) + 1)
    ref = middle_block_pallas_v2(*jx, interpret=True, precise=True, images_per_step=ips,
                                 per_image_dot=per_image_dot)
    _check(middle_block(*port), ref, f"v2 precise {shape} {dtype} ips={ips} pid={per_image_dot}")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_taps_match_jax_v2_imprecise(shape, dtype):
    """``taps="bf16"`` against ``precise=False``. The tap chains agree bit
    for bit; after the pointwise, a CPU run of this test reads 100 % of the
    outputs bit-equal at bf16 I/O and 99.06-100 % at fp32 I/O, where the
    pointwise's fp32 summation order shows in the last bit. Bound: 95 %."""
    jx, port = _case(*shape, dtype, seed=sum(shape) + 2)
    got = middle_block(*port, taps="bf16")
    assert torch.equal(got, middle_block_ref(*port, taps="bf16"))
    equal = _check(got, middle_block_pallas_v2(*jx, interpret=True, precise=False),
                   f"v2 bf16 taps {shape} {dtype}")
    assert equal >= 0.95


def test_bf16_taps_differ_from_fp32_taps():
    """The control of the test above: at fp32 I/O the two tap orders agree on
    0.03 % of the outputs, far below its 95 %."""
    _, port = _case(3, 8, 8, 16, "float32", seed=5)
    a, b = middle_block_ref(*port, taps="bf16"), middle_block_ref(*port)
    assert (a == b).float().mean().item() < 0.01 and (a - b).abs().max().item() > 1e-4


def test_bf16_tap_depthwise_is_bit_equal_to_xla():
    """The plain bf16 tap chain against the same chain in jnp bf16 (v2's
    ``dw_taps`` with a bf16 accumulator: bf16 taps, products and running
    sums, dy-major, zero halo), in eager jnp ops, on 4096 lanes."""
    rng = np.random.default_rng(11)
    B, H, W, C = 2, 5, 7, 4096
    a = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    taps = rng.normal(0, 0.3, (9, C)).astype(np.float32)
    got = depthwise3x3_ref(torch.from_numpy(a), torch.from_numpy(taps), "bf16").numpy()

    ap = jnp.pad(jnp.asarray(a, jnp.bfloat16), ((0, 0), (1, 1), (1, 1), (0, 0)))
    t = jnp.asarray(taps, jnp.bfloat16)
    acc = None
    for dy in range(3):
        for dx in range(3):
            p = ap[:, dy:dy + H, dx:dx + W, :] * t[dy * 3 + dx]
            acc = p if acc is None else acc + p
    np.testing.assert_array_equal(got, np.asarray(acc.astype(jnp.float32)))
