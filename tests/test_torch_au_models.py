"""The port's BiLSTM, ResNet-18 and both AU models against the JAX package,
fp32 on the CPU.

One JAX-initialised tree of each AU model, with randomised BN statistics on
every ResNet-18, goes into the port through ``utils/jax_weights.py``; the
inputs are seeded numpy arrays at small shapes (images of 16^2-32^2, B <= 2,
T <= 4, A <= 3, ``lstm_hidden`` 4-8; ResNet-18's widths are fixed).

Bars and CPU readings (max |d|):

- ``bilstm_apply`` (every ``valid_T`` form) and the reverse ``lstm_apply``
  with its final state: rtol 1e-5 / atol 1e-6, the ops bar of
  ``tests/test_torch_ops.py`` (reading 1.2e-7);
- ResNet-18 eval, the folded ResNet-18 and both models' tokens, logits and
  pooled embeddings: rtol 1e-3 / atol 2e-4, the feature bar (readings:
  ResNet-18 features 1.9e-6, folded 2.1e-6; AU-patch logits 7.5e-9 and
  pooled 4.5e-8; AU-face tokens 2.1e-7, logits 1.3e-8); the folded
  ResNet-18 against the port's own eval ResNet-18 at the same bar (the fold
  is exact up to rounding, reading 2.4e-6);
- the bridge round trip: bit-equal.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from multimodal_deepfake_detection_tpu.models import au_face as jau  # noqa: E402
from multimodal_deepfake_detection_tpu.models import fold as jfold  # noqa: E402
from multimodal_deepfake_detection_tpu.models import resnet as jres  # noqa: E402
from multimodal_deepfake_detection_tpu.models import resnet_lstm as jrl  # noqa: E402
from multimodal_deepfake_detection_tpu.ops import lstm as jlstm  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models import au_face as tau  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models import fold as tfold  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.models import resnet_lstm as trl  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.ops import lstm as tlstm  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

from au_trees import face_tree, patch_tree  # noqa: E402

OPS = dict(rtol=1e-5, atol=1e-6)
FEAT = dict(rtol=1e-3, atol=2e-4)
F32 = jnp.float32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, ref, bar, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), err_msg=msg, **bar)


@pytest.fixture(scope="module")
def patch_model():
    """The JAX AU-patch tree (hidden 8, lstm_hidden 4) and its port."""
    params, state = patch_tree()
    return params, state, jax_weights.au_patch_from_jax(params, state)


@pytest.fixture(scope="module")
def face_model():
    """The JAX AU-face tree (lstm_hidden 4: tokens of 8) and its port."""
    params, state = face_tree()
    return params, state, jax_weights.au_face_from_jax(params, state)


def _images(shape, seed):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("valid_T", [None, 3, np.array([5, 2, 1], np.int32)],
                         ids=["full", "scalar", "per_sample"])
def test_bilstm_matches_jax(valid_T):
    """``bilstm_apply`` with ``valid_T`` absent, scalar and per sample (one
    row gated at its first step), and the reverse pass alone."""
    params = _np(jlstm.bilstm_init(jax.random.PRNGKey(5), 6, 4))
    x = np.random.default_rng(5).normal(size=(3, 5, 6)).astype(np.float32)
    ref = jlstm.bilstm_apply(params, jnp.asarray(x), valid_T=valid_T)
    tp = tlstm.BiLSTM(6, 4)
    for d in ("fwd", "bwd"):
        for k, v in params[d].items():
            getattr(getattr(tp, d), k).data = torch.from_numpy(v)
    vt = None if valid_T is None else torch.as_tensor(valid_T)
    with torch.no_grad():
        got = tlstm.bilstm_apply(tp, torch.from_numpy(x), valid_T=vt)
        rev, (h, c) = tlstm.lstm_apply(tp.bwd, torch.from_numpy(x), reverse=True, valid_T=vt)
    _close(got, ref, OPS, "bilstm")
    ref_rev, (rh, rc) = jlstm.lstm_apply(params["bwd"], jnp.asarray(x), reverse=True,
                                         valid_T=valid_T)
    _close(rev, ref_rev, OPS)
    _close(h, rh, OPS)
    _close(c, rc, OPS)
    if valid_T is not None:  # every row's padded tail outputs the zero initial state
        for row, n in enumerate(np.broadcast_to(valid_T, (3,))):
            assert torch.equal(rev[row, n:], torch.zeros_like(rev[row, n:]))


def test_reverse_gate_holds_state_at_init_through_the_padding():
    """A reverse pass over a padded axis: the outputs at the valid steps do
    not depend on what the padding holds, and the padded steps output the
    initial (zero) state."""
    lstm = tlstm.LSTM(3, 4, torch.Generator().manual_seed(0))
    x = torch.randn(2, 6, 3, generator=torch.Generator().manual_seed(1))
    y = x.clone()
    y[:, 4:] = 100.0
    with torch.no_grad():
        a, _ = tlstm.lstm_apply(lstm, x, reverse=True, valid_T=4)
        b, _ = tlstm.lstm_apply(lstm, y, reverse=True, valid_T=4)
        short, _ = tlstm.lstm_apply(lstm, x[:, :4], reverse=True)
    torch.testing.assert_close(a[:, :4], b[:, :4], rtol=0, atol=0)
    torch.testing.assert_close(a[:, :4], short, rtol=0, atol=0)
    assert torch.equal(a[:, 4:], torch.zeros_like(a[:, 4:]))


def test_resnet18_eval_and_fold_match_jax(patch_model):
    params, state, port = patch_model
    x = _images((2, 32, 32, 3), 6)
    ref = jres.resnet18_apply(params["backbone"], state["backbone"], jnp.asarray(x))[0]
    folded_ref = jfold.folded_resnet18_apply(
        jfold.fold_resnet18_bn(params["backbone"], state["backbone"]), jnp.asarray(x))
    with torch.no_grad():
        got = port.backbone(torch.from_numpy(x))
        folded = tfold.fold_resnet18_bn(port.backbone)(torch.from_numpy(x))
    assert got.shape == (2, 512)
    _close(got, ref, FEAT, "resnet")
    _close(folded, folded_ref, FEAT, "folded")
    _close(folded, got, FEAT, "fold vs eval")


def test_bridge_round_trips_bit_equal(patch_model, face_model):
    for params, state, port, to_jax in ((*patch_model, jax_weights.au_patch_to_jax),
                                        (*face_model, jax_weights.au_face_to_jax)):
        p2, s2 = to_jax(port)
        for a, b in zip(jax.tree_util.tree_leaves((params, state)),
                        jax.tree_util.tree_leaves((p2, s2))):
            assert a.shape == b.shape and np.array_equal(a, b)
        assert (jax.tree_util.tree_structure((params, state))
                == jax.tree_util.tree_structure((p2, s2)))


PATCH_CASES = {  # id: (lengths, mask_padding)
    "no_lengths": (None, True),
    "quality": (np.array([4, 2], np.int32), True),
    "fidelity": (np.array([3, 2], np.int32), False),
}


@pytest.fixture(scope="module")
def patch_inputs():
    rng = np.random.default_rng(7)
    patches = _images((2, 4, 3, 16, 16, 3), 7)
    weights = rng.uniform(0.1, 1.0, (2, 4, 3)).astype(np.float32)
    return patches, weights


@pytest.mark.parametrize("case", list(PATCH_CASES))
@pytest.mark.parametrize("pooled", [False, True], ids=["logits", "pooled"])
def test_au_patch_classifier_matches_jax(patch_model, patch_inputs, case, pooled):
    """Every ``lengths`` x ``mask_padding`` case, with the external weights,
    logits and ``return_pooled``."""
    params, state, port = patch_model
    patches, weights = patch_inputs
    lengths, mask_padding = PATCH_CASES[case]
    ref = jrl.au_patch_classifier_apply(
        params, state, jnp.asarray(patches), jnp.asarray(weights),
        lengths=None if lengths is None else jnp.asarray(lengths), mask_padding=mask_padding,
        compute_dtype=F32, return_pooled=pooled)[0]
    with torch.no_grad():
        got = trl.au_patch_classifier_apply(
            port, torch.from_numpy(patches), torch.from_numpy(weights),
            lengths=None if lengths is None else torch.from_numpy(lengths).long(),
            mask_padding=mask_padding, compute_dtype=torch.float32, return_pooled=pooled)
    assert got.shape == ((2, 8) if pooled else (2, 1))
    _close(got, ref, FEAT, f"patch {case} {pooled}")


def test_au_patch_backbone_fn_replaces_the_backbone(patch_model, patch_inputs):
    """``backbone_fn`` takes the flat patches; the folded ResNet-18 there
    gives the eval forward's logits."""
    _, _, port = patch_model
    patches, weights = patch_inputs
    folded = tfold.fold_resnet18_bn(port.backbone)
    seen = []

    def fn(flat):
        seen.append(tuple(flat.shape))
        return folded(flat)

    with torch.no_grad():
        x, w = torch.from_numpy(patches), torch.from_numpy(weights)
        got = trl.au_patch_classifier_apply(port, x, w, backbone_fn=fn)
        ref = trl.au_patch_classifier_apply(port, x, w)
    assert seen == [(24, 16, 16, 3)]
    _close(got, ref, FEAT)


FACE_CASES = {  # id: (au_mask row pattern, weights, v_valid, au_valid)
    "plain": (False, False, None, None),
    "mask_weight": (True, True, None, None),
    "valid": (True, True, 2, 3),
}


@pytest.fixture(scope="module")
def face_inputs():
    rng = np.random.default_rng(8)
    videos = _images((2, 3, 32, 32, 3), 8)
    patches = _images((2, 4, 3, 16, 16, 3), 9)
    mask = (rng.uniform(size=(2, 4, 3)) > 0.3).astype(np.float32)
    mask[1, 3] = 0.0  # a padded AU step: uniform attention, as in JAX
    weight = rng.uniform(0.1, 1.0, (2, 4, 3)).astype(np.float32)
    return videos, patches, mask, weight


@pytest.mark.parametrize("case", list(FACE_CASES))
def test_au_face_detector_matches_jax(face_model, face_inputs, case):
    """Logits and both token streams, with ``au_mask`` (one all-zero row),
    ``au_weight`` and ``v_valid`` / ``au_valid`` (valid >= 1: 0 gives NaN on
    both sides)."""
    params, state, port = face_model
    videos, patches, mask, weight = face_inputs
    use_mask, use_weight, v_valid, au_valid = FACE_CASES[case]
    m = mask if use_mask else None
    w = weight if use_weight else None
    ref = jau.au_face_detector_apply(
        params, state, jnp.asarray(videos), jnp.asarray(patches),
        None if m is None else jnp.asarray(m), None if w is None else jnp.asarray(w),
        v_valid=v_valid, au_valid=au_valid, compute_dtype=F32)
    t = lambda a: None if a is None else torch.from_numpy(a)
    with torch.no_grad():
        got = tau.au_face_detector_apply(port, t(videos), t(patches), t(m), t(w),
                                         v_valid=v_valid, au_valid=au_valid,
                                         compute_dtype=torch.float32)
    assert [tuple(g.shape) for g in got] == [(2, 1), (2, 3, 8), (2, 4, 8)]
    for name, g, r in zip(("logits", "v_tokens", "au_tokens"), got, ref[:3]):
        assert torch.isfinite(g).all()
        _close(g, r, FEAT, name)
