"""On the card: each cell, at its own size over a short window, comes
out correct, and its control (the port's own int8 path, ``quantize=
"w8a8-pallas"``, the precision below the configuration's bf16) comes out
not correct. Run on the card:

    python -m pytest bench_port/tests/test_bench_gpu.py -q
"""
import time

import pytest
import torch

from bench_port import harness

SEEDS = (2 ** 31 + 4242, 2 ** 32 + 4243)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs the port's int8 kernels")
    return torch.device("cuda")


def _run(cell, seed, program=None):
    return harness.run(cell, seed, 2.0, False, t_start=time.perf_counter(), program=program,
                       log=lambda m: None)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["visual-bulk", "audio-bulk"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_passes_and_the_control_fails(card, cell, seed):
    sound = _run(cell, seed)
    assert sound["correct"], sound["compared"]
    control = _run(cell, seed, {"quantize": "w8a8-pallas"})
    assert not control["correct"], control["compared"]
