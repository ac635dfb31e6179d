"""The port's versioned checkpoints (``core/orbax_ckpt.py`` on
``torch.distributed.checkpoint``): the twin of ``tests/test_orbax_ckpt.py``.

The save/restore round trip with rolling retention, an empty directory, a
half-written step that must never be restored, ``train_audio
--ckpt_backend orbax`` for two epochs then ``--resume auto`` (the JAX test's
arguments and sizes), and the other three trainers' flag: one epoch each at
their tests' smallest widths, restored into a freshly built state.
"""
import os

import numpy as np
import pytest
import torch

from multimodal_deepfake_detection_tpu_torch.cli import (
    train_au_face as tface_cli,
    train_au_patch as tpatch_cli,
    train_visual as tvisual_cli,
)
from multimodal_deepfake_detection_tpu_torch.cli.common import ResumeState
from multimodal_deepfake_detection_tpu_torch.core.config import parse_config
from multimodal_deepfake_detection_tpu_torch.core.orbax_ckpt import OrbaxStateManager
from multimodal_deepfake_detection_tpu_torch.data.synthetic import (
    make_au_patch_tree,
    make_face_npy_tree,
    make_joint_tree,
)
from multimodal_deepfake_detection_tpu_torch.train import TrainState, ema_init, make_optimizer


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _state(v, accum_steps=1):
    model = torch.nn.Linear(4, 3)
    with torch.no_grad():
        model.weight.fill_(float(v))
        model.bias.copy_(torch.arange(3.0))
    opt = make_optimizer(model.parameters(), "adam", 1e-3, accum_steps=accum_steps)
    return TrainState(v, model, opt, ema_init(model))


def _step(state):
    state.optimizer.zero_grad()
    state.model(torch.ones(2, 4)).square().sum().backward()
    state.optimizer.step()


def test_roundtrip_and_retention(tmp_path):
    mgr = OrbaxStateManager(str(tmp_path / "ck"), max_to_keep=2)
    for step in (1, 2, 3):
        state = _state(step, accum_steps=2)
        for _ in range(3):  # one core step, one micro-batch folded in
            _step(state)
        mgr.save(step, state)
    assert mgr.latest_step() == 3

    restored = mgr.restore_latest(like=_state(0, accum_steps=2))
    assert restored.step == 3
    for a, b in zip(restored.model.state_dict().values(), state.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    got, want = restored.optimizer.state_dict(), state.optimizer.state_dict()
    assert (got["mini_step"], got["count"]) == (want["mini_step"], want["count"]) == (1, 1)
    for a, b in zip(got["acc"], want["acc"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in ("exp_avg", "exp_avg_sq", "step"):
        torch.testing.assert_close(got["core"]["state"][0][k], want["core"]["state"][0][k],
                                   rtol=0, atol=0)

    # rolling retention: only the last 2 steps survive
    kept = sorted(d for d in os.listdir(tmp_path / "ck") if d.isdigit())
    assert kept == ["2", "3"]
    mgr.close()


def test_empty_directory_returns_none(tmp_path):
    mgr = OrbaxStateManager(str(tmp_path / "empty"))
    assert mgr.latest_step() is None
    assert mgr.restore_latest(like=_state(0)) is None
    mgr.close()


def test_half_written_step_is_ignored(tmp_path):
    """A step directory without its completion mark (a save cut short after
    DCP's ``.metadata``) and a temporary directory are never restored."""
    ck = tmp_path / "ck"
    mgr = OrbaxStateManager(str(ck))
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    (ck / "2" / "COMMITTED").unlink()  # as if the save had stopped before its mark
    (ck / ".tmp-3").mkdir()
    (ck / ".tmp-3" / ".metadata").write_bytes(b"partial")
    assert mgr.all_steps() == [1] and mgr.latest_step() == 1
    restored = mgr.restore_latest(like=_state(0))
    assert restored.step == 1
    assert float(restored.model.weight.detach()[0, 0]) == 1.0


def test_train_audio_orbax_backend_and_auto_resume(tmp_path):
    from multimodal_deepfake_detection_tpu_torch.cli.train_audio import main
    from multimodal_deepfake_detection_tpu_torch.data.synthetic import make_audio_npy_tree

    tree = make_audio_npy_tree(str(tmp_path / "a"), n_per_class=2, frames=8)
    ck = str(tmp_path / "ck")
    args = [
        "--train_folder", f"{tree}/train", "--eval_folder", f"{tree}/eval",
        "--checkpoint_dir", ck, "--hidden_dim", "8", "--batch_size", "4",
        "--epochs", "2", "--eval_every", "1", "--buckets", "8",
        "--compute_dtype", "float32", "--ckpt_backend", "orbax", "--device", "cpu",
    ]
    main(args, log=lambda s: None)
    assert sorted(d for d in os.listdir(os.path.join(ck, "train_audio_orbax")) if d.isdigit()) \
        == ["1", "2"]
    logs = []
    main(args + ["--epochs", "1", "--resume", "auto"], log=logs.append)
    assert any("resumed from orbax step 2" in line for line in logs)


def _visual(tmp_path):
    tree = make_face_npy_tree(str(tmp_path / "faces"), n_per_class=1, frames=3, size=32, seed=0)
    return ["--train_folder", f"{tree}/train", "--eval_folder", f"{tree}/eval",
            "--max_frames", "3", "--buckets", "3", "--batch_size", "2", "--hidden_dim", "4"]


def _au_patch(tmp_path):
    root = make_au_patch_tree(str(tmp_path / "tree"), n_per_class=2, frames=2, n_aus=2, size=16,
                              seed=5)
    return ["--data_root", root, "--hidden_dim", "8", "--lstm_hidden", "4", "--image_size",
            "16", "--max_frames", "2", "--max_aus", "2"]


def _au_face(tmp_path):
    video, au = make_joint_tree(str(tmp_path / "v"), str(tmp_path / "a"), n_per_class=2,
                                frames=2, n_aus=2, face_size=16, patch_size=16, seed=6)
    return ["--video_root", video, "--au_root", au, "--num_aus", "2", "--lstm_hidden", "4",
            "--face_dim", "8", "--au_dim", "8", "--embed_dim", "8", "--image_size", "16",
            "--max_frames", "2", "--accum_steps", "2"]  # the epoch's 2 batches: one step


@pytest.mark.parametrize("cli,name,argv", [
    (tvisual_cli, "train_visual", _visual),
    (tpatch_cli, "train_au_patch", _au_patch),
    (tface_cli, "train_au_face", _au_face),
])
def test_trainer_takes_the_orbax_backend(cli, name, argv, tmp_path):
    """One epoch with ``--ckpt_backend orbax`` writes step 1, and a freshly
    built state restores it (``--resume auto``): the step count, the
    parameters, the optimizer's counts and, for au_face, its EMA."""
    ck = str(tmp_path / "ck")
    argv = argv(tmp_path) + ["--checkpoint_dir", ck, "--epochs", "1", "--ckpt_backend",
                             "orbax", "--compute_dtype", "float32", "--device", "cpu"]
    cli.main(argv, log=lambda s: None)
    orbax_dir = os.path.join(ck, f"{name}_orbax")
    assert sorted(os.listdir(orbax_dir)) == ["1"]
    config = parse_config(cli.Config, argv + ["--resume", "auto"], prog=name)
    state = cli.build(config)[-3]
    fresh = {k: v.clone() for k, v in state.model.state_dict().items()}
    logs = []
    assert ResumeState(config, name).resume(state, config.resume, logs.append)
    assert logs == ["resumed from orbax step 1"] and state.step > 0
    assert state.optimizer.count > 0
    assert any(not torch.equal(fresh[k], v) for k, v in state.model.state_dict().items())
    if state.ema is not None:
        assert state.ema.count == state.optimizer.count
    assert np.isfinite([float(v.float().sum()) for v in state.model.state_dict().values()]).all()
