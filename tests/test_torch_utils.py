"""The port's utilities: the metric loggers and the trainers' ``--jsonl_log``
and ``--tracker``, the profiling hooks, input-gradient saliency and its PNG
grid, and the t-SNE plots.

The logger tests mirror ``tests/test_utils.py`` on the port's own
``EpochResult``. Parity with the JAX package:

- ``run_tsne_and_plot``: both copies on the same ``X`` and seed give the
  same ``Z`` (scikit-learn on the host; exactly equal);
- ``train_au_patch`` trained for one epoch by both CLIs from the same
  initial weights (the port's, exported), each with ``--jsonl_log``: the
  same events and keys, the losses within the trainer test's rtol 1e-3
  (``tests/test_torch_train_au.py``), every other scalar (AUC, pAUC, EER,
  ACC, the learning rate, the epoch) within atol 1e-6, the time fields
  excepted and the ``run_start`` configs held on the fields both CLIs have.
"""
import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from multimodal_deepfake_detection_tpu_torch.cli import common
from multimodal_deepfake_detection_tpu_torch.cli import train_au_face as tface_cli
from multimodal_deepfake_detection_tpu_torch.cli import train_au_patch as tpatch_cli
from multimodal_deepfake_detection_tpu_torch.cli import train_audio as taudio_cli
from multimodal_deepfake_detection_tpu_torch.cli import train_visual as tvisual_cli
from multimodal_deepfake_detection_tpu_torch.core.config import parse_config
from multimodal_deepfake_detection_tpu_torch.train.loop import EpochResult
from multimodal_deepfake_detection_tpu_torch.utils import metric_logger as M
from multimodal_deepfake_detection_tpu_torch.utils.profiling import StepTimer, annotate, trace
from multimodal_deepfake_detection_tpu_torch.utils.saliency import (
    input_saliency,
    normalize_map,
    save_saliency_grid,
)
from multimodal_deepfake_detection_tpu_torch.utils.visualize import run_tsne_and_plot

STRICT = dict(parse_constant=lambda c: (_ for _ in ()).throw(ValueError(c)))


def _epoch_result(epoch=0):
    return EpochResult(epoch=epoch, train_loss=0.5, train_metrics={"acc": 0.9},
                       eval_loss=0.4, eval_metrics={"AUC": 0.95}, lr=1e-4, seconds=1.2)


# ---------------------------------------------------------------------------
# Metric loggers
# ---------------------------------------------------------------------------

def test_jsonl_logger_strict_json_with_nan(tmp_path):
    path = str(tmp_path / "run.jsonl")
    logger = M.JsonlLogger(path, run_name="t", config={"lr": 1e-4})
    logger.log_epoch(EpochResult(epoch=0, train_loss=0.5,
                                 train_metrics={"AUC": float("nan"), "pAUC": float("inf")},
                                 eval_loss=0.4, eval_metrics={"AUC": 0.9}))
    logger.log(step=3, lr=1e-4)
    logger.close()
    objs = [json.loads(line, **STRICT) for line in open(path).read().splitlines()]
    assert len(objs) == 3
    assert objs[0]["event"] == "run_start" and objs[0]["config"]["lr"] == 1e-4
    assert objs[1]["train_metrics"] == {"AUC": None, "pAUC": None}
    assert objs[1]["eval_metrics"]["AUC"] == 0.9
    assert objs[2]["event"] == "scalar" and objs[2]["step"] == 3


def test_tensorboard_logger_writes_events(tmp_path):
    lg = M.TensorBoardLogger(str(tmp_path), run_name="r", config={"lr": 1e-4})
    lg.log_epoch(_epoch_result())
    lg.log(step_time=0.1)
    lg.close()
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert any("tfevents" in f for f in files)


def test_wandb_logger_with_fake_module(monkeypatch):
    calls = {"log": [], "init": [], "config": [], "finish": 0}
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: calls["init"].append(kw) or types.SimpleNamespace(**kw)
    fake.config = types.SimpleNamespace(update=lambda d: calls["config"].append(d))
    fake.log = lambda scalars, step=None: calls["log"].append((scalars, step))
    fake.finish = lambda: calls.__setitem__("finish", calls["finish"] + 1)
    monkeypatch.setitem(sys.modules, "wandb", fake)

    lg = M.WandbLogger("proj", run_name="r", config={"lr": 1e-4})
    lg.log_epoch(_epoch_result(epoch=3))
    lg.close()
    assert calls["init"][0]["project"] == "proj" and calls["init"][0]["resume"] is True
    assert calls["config"] == [{"lr": 1e-4}]
    scalars, step = calls["log"][0]
    assert step == 3
    assert scalars == {"Loss/Train": 0.5, "Epoch Time": 1.2, "LR": 1e-4, "acc/Train": 0.9,
                       "Loss/Eval": 0.4, "AUC/Eval": 0.95}
    assert calls["finish"] == 1


def test_wandb_logger_without_wandb_names_the_other_sinks(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises ImportError
    with pytest.raises(ImportError, match="--jsonl_log"):
        M.WandbLogger("proj")


def test_make_metric_logger_multi_and_errors(tmp_path):
    assert M.make_metric_logger([]) is None
    assert M.make_metric_logger(None) is None
    lg = M.make_metric_logger(f"jsonl:{tmp_path / 'm.jsonl'},tensorboard:{tmp_path / 'tb'}",
                              run_name="r")
    assert isinstance(lg, M.MultiLogger) and len(lg.loggers) == 2
    lg.log_epoch(_epoch_result())
    lg.close()
    assert [json.loads(x)["event"] for x in open(tmp_path / "m.jsonl")] == ["run_start", "epoch"]
    with pytest.raises(ValueError, match="needs an argument"):
        M.make_metric_logger(["tensorboard"])
    with pytest.raises(ValueError, match="unknown tracker kind"):
        M.make_metric_logger(["mlflow:x"])


@pytest.mark.parametrize("cli,name", [
    (tvisual_cli, "train_visual"), (taudio_cli, "train_audio"),
    (tpatch_cli, "train_au_patch"), (tface_cli, "train_au_face"),
])
def test_trainer_logger_flags_build_their_sinks(cli, name, tmp_path):
    """``--jsonl_log`` and ``--tracker`` pass each trainer's flag check and
    become a JSONL sink (its ``run_start`` holds the whole config) and a
    TensorBoard sink, as the JAX CLIs build them."""
    config = parse_config(cli.Config, ["--jsonl_log", str(tmp_path / "m.jsonl"), "--tracker",
                                       f"tensorboard:{tmp_path / 'tb'}", "--device", "cpu"],
                          prog=name)
    cli.check_config(config)
    lg = common.epoch_logger(config, name)
    assert [type(x).__name__ for x in lg.loggers] == ["JsonlLogger", "TensorBoardLogger"]
    lg.log_epoch(_epoch_result())
    lg.close()
    head = json.loads(open(tmp_path / "m.jsonl").readline())
    assert head["run"] == name and head["config"] == json.loads(
        json.dumps(dataclasses.asdict(config), default=str))
    assert any("tfevents" in f for _, _, fs in os.walk(tmp_path / "tb" / name) for f in fs)
    assert common.epoch_logger(cli.Config(), name) is None


def test_train_au_patch_jsonl_matches_jax(tmp_path, monkeypatch):
    """One epoch of ``train_au_patch`` in both packages, ``--jsonl_log``."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from multimodal_deepfake_detection_tpu.cli import train_au_patch as jpatch_cli
    from multimodal_deepfake_detection_tpu_torch.data.synthetic import make_au_patch_tree
    from multimodal_deepfake_detection_tpu_torch.models.resnet_lstm import AUPatchClassifier
    from multimodal_deepfake_detection_tpu_torch.utils import jax_weights

    root = make_au_patch_tree(str(tmp_path / "tree"), n_per_class=2, frames=2, n_aus=2, size=16,
                              seed=5)
    argv = ["--data_root", root, "--hidden_dim", "8", "--lstm_hidden", "4", "--image_size", "16",
            "--max_frames", "2", "--max_aus", "2", "--epochs", "1", "--compute_dtype", "float32",
            "--seed", "3", "--save_resume_state", "false"]
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tpatch_cli.main(argv + ["--checkpoint_dir", str(tmp_path / "t"), "--device", "cpu",
                                "--jsonl_log", str(tmp_path / "t.jsonl")], log=lambda s: None)
    finally:
        torch.set_num_threads(before)
    init = AUPatchClassifier(8, 4, generator=torch.Generator().manual_seed(3))
    trees = jax_weights.au_patch_to_jax(init)
    monkeypatch.setattr(jpatch_cli, "au_patch_classifier_init",
                        lambda *a, **kw: jax.tree_util.tree_map(jnp.asarray, trees))
    monkeypatch.setenv("MDD_NO_COMPILE_CACHE", "1")
    jpatch_cli.main(argv + ["--checkpoint_dir", str(tmp_path / "j"),
                            "--jsonl_log", str(tmp_path / "j.jsonl")], log=lambda s: None)

    t_objs = [json.loads(x, **STRICT) for x in open(tmp_path / "t.jsonl")]
    j_objs = [json.loads(x, **STRICT) for x in open(tmp_path / "j.jsonl")]
    assert [o["event"] for o in t_objs] == [o["event"] for o in j_objs] == ["run_start", "epoch"]
    for t, j in zip(t_objs, j_objs):
        assert sorted(t) == sorted(j)
    t_cfg, j_cfg = t_objs[0]["config"], j_objs[0]["config"]
    shared = sorted(set(t_cfg) & set(j_cfg) - {"checkpoint_dir", "jsonl_log"})
    assert set(j_cfg) - set(t_cfg) == set() and len(shared) > 20
    assert {k: t_cfg[k] for k in shared} == {k: j_cfg[k] for k in shared}
    t, j = t_objs[1], j_objs[1]
    for key in ("train_metrics", "eval_metrics"):
        assert sorted(t[key]) == sorted(j[key])
    np.testing.assert_allclose([t["train_loss"], t["eval_loss"]],
                               [j["train_loss"], j["eval_loss"]], rtol=1e-3)
    def scalars(o):  # NaN metrics are written as null
        vals = [o["epoch"], o["lr"]] + [o[k][m] for k in ("train_metrics", "eval_metrics")
                                        for m in sorted(o[k])]
        return np.array([np.nan if v is None else v for v in vals], np.float64)

    np.testing.assert_allclose(scalars(t), scalars(j), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Profiling hooks
# ---------------------------------------------------------------------------

def test_step_timer():
    t = StepTimer("step")
    assert t.summary() == "step: no samples"
    for _ in range(3):
        with t:
            pass
    s = t.summary()
    assert s.startswith("step: n=3") and "p95" in s


def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    with trace(str(tmp_path)):
        with annotate("eval_batch"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path) for f in fs]
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert "eval_batch" in open(files[0]).read()


# ---------------------------------------------------------------------------
# Saliency
# ---------------------------------------------------------------------------

def test_input_saliency_unit():
    """Saliency of a known quadratic score is the analytic |2x| map."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 3, 4, 4, 3)).astype(np.float32))
    sal = input_saliency(lambda v: (v ** 2).sum(dim=(1, 2, 3, 4)), x)
    ref = np.max(np.abs(2 * x.numpy()), axis=-1)
    np.testing.assert_allclose(sal.numpy(), ref, rtol=1e-6)
    assert sal.dtype == torch.float32 and not x.requires_grad
    n = normalize_map(sal.numpy())
    assert n.min() >= 0 and n.max() <= 1


def test_input_saliency_keeps_no_parameter_gradient():
    """The gradient is the input's alone, in eval mode and with parameters
    that require gradients: none of them gets one; a bf16 model's map is
    fp32; samples don't mix."""
    conv = torch.nn.Conv2d(3, 4, 3).eval()
    score = lambda v, scale: scale * conv(v.permute(0, 3, 1, 2)).mean(dim=(1, 2, 3))  # noqa
    x = torch.rand(2, 8, 8, 3)
    sal = input_saliency(score, x, 2.0)
    assert sal.shape == (2, 8, 8) and all(p.grad is None for p in conv.parameters())
    np.testing.assert_allclose(input_saliency(score, x[:1], 2.0), sal[:1], rtol=1e-6)
    conv.to(torch.bfloat16)
    bf = input_saliency(lambda v: conv(v.to(torch.bfloat16).permute(0, 3, 1, 2)).mean((1, 2, 3)), x)
    assert bf.dtype == torch.float32 and torch.isfinite(bf).all()


def test_saliency_grid_png(tmp_path):
    frames = np.random.default_rng(1).random((2, 3, 8, 8, 3)).astype(np.float32)
    sal = np.random.default_rng(2).random((2, 3, 8, 8)).astype(np.float32)
    lines = []
    path = save_saliency_grid(frames, sal, str(tmp_path / "sal" / "g.png"),
                              scores=np.array([0.2, 0.9]), labels=np.array([0, 1]),
                              log=lines.append)
    assert os.path.getsize(path) > 1000 and lines == [f"[Saliency] saved -> {path}"]


# ---------------------------------------------------------------------------
# t-SNE
# ---------------------------------------------------------------------------

def test_tsne_matches_jax_copy(tmp_path):
    from multimodal_deepfake_detection_tpu.utils.visualize import run_tsne_and_plot as jax_tsne

    X = np.random.default_rng(0).normal(0, 1, (40, 8))
    y = np.array([0, 1] * 20)
    z = run_tsne_and_plot(X, y, "t", str(tmp_path / "t.png"), seed=0, n_iter=260,
                          max_samples=30, log=lambda s: None)
    jz = jax_tsne(X, y, "t", str(tmp_path / "j.png"), seed=0, n_iter=260, max_samples=30,
                  log=lambda s: None)
    assert z.shape == (30, 2)
    np.testing.assert_array_equal(z, jz)
    assert os.path.getsize(tmp_path / "t.png") > 1000
    logs = []
    assert run_tsne_and_plot(np.zeros((0, 4)), np.zeros(0), "e", str(tmp_path / "e.png"),
                             log=logs.append) is None
    assert logs == ["[t-SNE] No data for e; skipped."] and not (tmp_path / "e.png").exists()
