"""Seeded JAX trees of both AU models for the port's AU parity tests.

Each tree is JAX-initialised (jitted: eager init of a ResNet-18 takes ~10 s
on the CPU), gets randomised BN statistics on every ResNet-18, and is built
once per process and shared by the test files that ask for it: treat the
numpy trees as read-only.
"""
import functools

import jax
import numpy as np

from multimodal_deepfake_detection_tpu.models import au_face as jau
from multimodal_deepfake_detection_tpu.models import resnet_lstm as jrl

from test_torch_serve import _randomize_bn

PATCH_HIDDEN, PATCH_LSTM = 8, 4
FACE_LSTM = 4  # tokens of 8


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def patch_tree():
    """-> (params, state) of an AU-patch classifier (hidden 8, lstm_hidden 4)."""
    init = functools.partial(jrl.au_patch_classifier_init, hidden_dim=PATCH_HIDDEN,
                             lstm_hidden=PATCH_LSTM)
    params, state = _np(jax.jit(init)(jax.random.PRNGKey(3)))
    _randomize_bn(params["backbone"], state["backbone"], np.random.default_rng(3))
    return params, state


@functools.lru_cache(maxsize=None)
def face_tree():
    """-> (params, state) of an AU-face detector (lstm_hidden 4, 3 AUs)."""
    init = functools.partial(jau.au_face_detector_init, num_aus=3, face_dim=2 * FACE_LSTM,
                             au_dim=2 * FACE_LSTM, lstm_hidden=FACE_LSTM)
    params, state = _np(jax.jit(init)(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    for key in ("face_backbone", "au_backbone"):
        _randomize_bn(params[key], state[key], rng)
    return params, state
