"""K4's plain PyTorch version against its three JAX TPU kernels, on the CPU.

``entry_pair_pallas`` (with ``entry_pair``), ``sepconv_pair_stream_pallas``
and ``sepconv_pair_stream2_pallas`` run in interpret mode, as
tests/test_pallas_sepconv.py and tests/test_pallas_stream.py run them, each
against the port's plain version with that entry point's switches:
``col_sums=True`` for ``entry_pair_pallas``; ``col_sums=False,
mid_fp32=True`` for the stream kernel; ``col_sums=dx_roll`` for stream2.

The stream kernels multiply by ``pw`` in the dtype they are given; both
sides get bf16-representable weights (fp32 arrays to JAX, packed bf16 rows
to the port), so the pointwise products are exact on both. Both sides round
at the same points, so only fp32 summation order can flip a bf16 rounding:
the bound is rtol = atol = 1.6e-2 (two bf16 ulps at unit scale), as for K3.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_entry import (  # noqa: E402
    entry_pair as jax_entry_pair,
)
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_entry import (  # noqa: E402
    entry_pair_pallas,
)
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_stream import (  # noqa: E402
    pack_pair as jax_pack_pair,
)
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_stream import (  # noqa: E402
    sepconv_pair_stream_pallas,
)
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_stream2 import (  # noqa: E402
    pack_pair2 as jax_pack_pair2,
)
from multimodal_deepfake_detection_tpu.ops.pallas.sepconv_stream2 import (  # noqa: E402
    sepconv_pair_stream2_pallas,
)
from multimodal_deepfake_detection_tpu_torch.ops.kernels._plain import (  # noqa: E402
    depthwise3x3_ref,
)
from multimodal_deepfake_detection_tpu_torch.ops.kernels.entry_pair import (  # noqa: E402
    entry_pair,
    entry_pair_ref,
    pack_pair,
)

BF16_TOL = 1.6e-2
JAX_SHAPE = (3, 11, 7, 8, 16, 24)  # tests/test_pallas_stream.py's
C40 = (2, 6, 5, 40, 40, 48)  # rows padded 40 -> 64
TINY = (3, 2, 2, 16, 24, 8)
WIDE = (1, 3, 520, 8, 16, 8)  # wider than the first design's depthwise band took (512)


def _bf16_values(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _case(B, H, W, Cin, Cmid, Cout, dtype, seed):
    """Seeded x and JAX-layout weights (taps (9, C), pointwise [in, out] with
    bf16 values); the port's pointwise rows [out, in] padded by 32 columns of
    NaN, which neither the kernel nor its plain version may read."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, s: rng.standard_normal(shape).astype(np.float32) * s
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(f(B, H, W, Cin, s=1.0), jdt)
    ops = (f(9, Cin, s=0.2), _bf16_values(f(Cin, Cmid, s=0.1)), f(Cmid, s=0.3),
           f(9, Cmid, s=0.2), _bf16_values(f(Cmid, Cout, s=0.1)), f(Cout, s=0.3))

    def rows(w):
        out = torch.full((w.shape[1], w.shape[0] + 32), float("nan"))
        out[:, : w.shape[0]] = torch.from_numpy(w.T)
        return out.to(torch.bfloat16)

    dw0, pw0, b0, dw1, pw1, b1 = ops
    t = torch.from_numpy
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    return (xj, *map(jnp.asarray, ops)), (x, t(dw0), rows(pw0), t(b0), t(dw1), rows(pw1), t(b1))


def _check(got, ref, label):
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    print(f"{label}: max|d|={np.abs(got - ref).max():.3e} bit-equal share={np.mean(got == ref):.4f}")
    np.testing.assert_allclose(got, ref, rtol=BF16_TOL, atol=BF16_TOL, err_msg=label)


def _port(port, dtype, **switches):
    got = entry_pair(*port, **switches)
    B, H, W, _ = port[0].shape
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (B, H, W, port[5].shape[0])
    return got


@pytest.mark.parametrize("shape,lead,dtype", [
    (JAX_SHAPE, False, "float32"), (JAX_SHAPE, True, "float32"),
    (JAX_SHAPE, False, "bfloat16"), (JAX_SHAPE, True, "bfloat16"),
    (C40, True, "bfloat16"), (TINY, False, "float32"), (WIDE, True, "bfloat16"),
])
def test_ref_matches_jax_entry_pair(shape, lead, dtype):
    """``entry_pair_pallas``'s valid columns ``[1:W+1]`` and ``entry_pair``."""
    jx, port = _case(*shape, dtype, seed=sum(shape) + lead)
    got = _port(port, dtype, leading_relu0=lead)
    W = shape[2]
    bordered = entry_pair_pallas(*jx, leading_relu0=lead, row_chunk=64, interpret=True)
    _check(got, bordered[:, :, 1:W + 1], f"entry_pair_pallas {shape} relu={lead} {dtype}")
    _check(got, jax_entry_pair(*jx, leading_relu0=lead, row_chunk=64, interpret=True),
           f"entry_pair {shape} relu={lead} {dtype}")


@pytest.mark.parametrize("shape,lead,dtype,stripes", [
    (JAX_SHAPE, False, "float32", 4), (JAX_SHAPE, True, "float32", 4),
    (JAX_SHAPE, False, "float32", 11), (JAX_SHAPE, True, "float32", 11),
    (JAX_SHAPE, False, "float32", 32), (JAX_SHAPE, True, "float32", 32),
    (JAX_SHAPE, True, "bfloat16", 4), (C40, True, "bfloat16", 4), (TINY, False, "float32", 32),
    (WIDE, False, "float32", 2),
])
def test_ref_matches_jax_stream(shape, lead, dtype, stripes):
    """The stream kernel: dy-major taps and an fp32 mid, at its test's stripe
    heights (partial last stripe, one stripe, taller than the image)."""
    jx, port = _case(*shape, dtype, seed=sum(shape) + 2 * lead)
    got = _port(port, dtype, leading_relu0=lead, col_sums=False, mid_fp32=True)
    ref = sepconv_pair_stream_pallas(*jx, leading_relu0=lead, stripe_rows=stripes,
                                     interpret=True)
    _check(got, ref, f"stream {shape} relu={lead} {dtype} stripes={stripes}")


@pytest.mark.parametrize("shape,lead,dtype,dx_roll,stripes", [
    (JAX_SHAPE, False, "float32", False, 11), (JAX_SHAPE, True, "float32", False, 11),
    (JAX_SHAPE, False, "float32", True, 11), (JAX_SHAPE, True, "float32", True, 11),
    (JAX_SHAPE, True, "bfloat16", False, 1), (JAX_SHAPE, True, "bfloat16", True, 1),
    (C40, True, "bfloat16", True, 3), (TINY, False, "float32", False, 2),
    (WIDE, True, "bfloat16", True, 3), (WIDE, False, "bfloat16", False, 1),
])
def test_ref_matches_jax_stream2(shape, lead, dtype, dx_roll, stripes):
    """Stream2: bf16 mid; dy-major taps without ``dx_roll``, column sums
    with it. ``stripe_rows`` must divide H there."""
    jx, port = _case(*shape, dtype, seed=sum(shape) + 3 * lead)
    got = _port(port, dtype, leading_relu0=lead, col_sums=dx_roll)
    ref = sepconv_pair_stream2_pallas(*jx, leading_relu0=lead, stripe_rows=stripes,
                                      dx_roll=dx_roll, row_chunk=64, interpret=True)
    _check(got, ref, f"stream2 {shape} relu={lead} {dtype} dx_roll={dx_roll} stripes={stripes}")


def test_switches_change_the_result():
    """What each switch changes. ``mid_fp32`` moves the output: at fp32 I/O
    only 2.7 % of it stays bit-equal, below every share the tests above
    print. ``col_sums`` reorders the depthwise's fp32 sums, which the bf16
    rounding after it hides at these sizes (the outputs above are bit-equal
    either way), so it is held on the depthwise itself, before the rounding."""
    _, port = _case(*JAX_SHAPE, "float32", seed=9)
    base = entry_pair_ref(*port, leading_relu0=True)
    other = entry_pair_ref(*port, leading_relu0=True, mid_fp32=True)
    assert (other == base).float().mean().item() < 0.1
    a, taps = port[0].float(), port[1]
    cols, dy = depthwise3x3_ref(a, taps, "cols"), depthwise3x3_ref(a, taps, "dy")
    assert (cols != dy).float().mean().item() > 0.05


def test_pack_pair_matches_jax_packers():
    """Against JAX ``pack_pair`` (stream) and ``pack_pair2`` (stream2), which
    return the same six arrays."""
    rng = np.random.default_rng(8)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    units_t, units_j = [], []
    for ci, co in ((24, 40), (40, 48)):
        dw, pw, b = f(ci, 1, 3, 3), f(co, ci, 1, 1), f(co)
        units_t.append(tuple(map(torch.from_numpy, (dw, pw, b))))
        units_j.append({"depthwise": {"w": jnp.asarray(dw.transpose(2, 3, 1, 0))},
                        "pointwise": {"w": jnp.asarray(pw.transpose(2, 3, 1, 0)),
                                      "b": jnp.asarray(b)}})
    got = pack_pair(units_t)
    for packer in (jax_pack_pair, jax_pack_pair2):
        want = packer({"units": units_j})
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.is_contiguous()
            if i in (1, 4):  # bf16 [out, in] here, fp32 [in, out] in JAX; rows padded to 32
                K = w.shape[0]
                assert g.dtype == torch.bfloat16 and g.shape[1] == -(-K // 32) * 32
                np.testing.assert_array_equal(g[:, :K].float().numpy(), _bf16_values(w).T)
                assert not g[:, K:].any()
            else:
                assert g.dtype == torch.float32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
