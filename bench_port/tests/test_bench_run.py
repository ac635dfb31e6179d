"""The command refuses to measure without a card, and the check sees a
broken timed path: a run whose answers are altered where they are produced
comes out not correct."""
import os
import subprocess
import sys
import time

import pytest
import torch

from bench_port import harness, spec
from bench_port.tests.small import small_cell

ROOT = os.path.dirname(spec.ROOT)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "visual-bulk",
                          "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def _alter_answers(scorer):
    """An answer altered where it is produced: row 0 of every call moved by
    half the probability range."""
    impl = scorer._score_impl

    def altered(*args):
        p = impl(*args).clone()
        p[0] = (p[0] + 0.5) % 1.0
        return p

    scorer._score_impl = altered


def _run(cell, fault=None):
    cfg, mix = small_cell(cell)
    with torch.no_grad():
        return harness.run(cell, 2 ** 31 + 99, 0.5, False, t_start=time.perf_counter(),
                           device="cpu", config=cfg, mix=mix, fault=fault, log=lambda m: None)


@pytest.mark.parametrize("cell", ["visual-bulk", "audio-bulk"])
def test_an_altered_answer_is_not_correct(cell):
    sound = _run(cell)
    assert sound["correct"], sound["compared"]
    broken = _run(cell, _alter_answers)
    assert not broken["correct"], broken["compared"]
    assert list(broken)[-1] == "compared"
