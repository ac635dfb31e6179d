"""The traffic generators are deterministic by seed, and every seed offers
the same work in another order."""
import numpy as np
import pytest
import torch

from bench_port import spec
from bench_port.tests.small import small_cell


def _plan(cell, seed, seconds=2.0):
    cfg, mix = small_cell(cell)
    gen, eng = spec.generator(mix["generator"]), spec.engine(cfg["engine"])
    return gen.plan(mix, cfg, eng, seed, seconds, torch.device("cpu"))


@pytest.mark.parametrize("cell", ["visual-bulk", "audio-bulk"])
def test_same_seed_same_inputs(cell):
    a, b = _plan(cell, 2 ** 31 + 3), _plan(cell, 2 ** 31 + 3)
    assert a.clips.keys() == b.clips.keys()
    for k in a.clips:
        np.testing.assert_array_equal(a.clips[k], b.clips[k])
    for k in a.data:
        if k != "batches":
            assert np.array_equal(np.asarray(a.data[k], dtype=object),
                                  np.asarray(b.data[k], dtype=object)), k


def test_bulk_seeds_share_the_lengths():
    a, b = _plan("visual-bulk", 5), _plan("visual-bulk", 2 ** 33 + 1)
    la = sorted(len(c) for c in a.clips.values())
    assert la == sorted(len(c) for c in b.clips.values())
    assert any(not np.array_equal(a.clips[k], b.clips[k]) for k in a.clips)
