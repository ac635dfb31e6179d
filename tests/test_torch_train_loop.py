"""The port's data pipeline, TrainLoop and train_visual CLI against the JAX package.

* ``DataLoader``: the same batches in the same order as the JAX loader for a
  seed (shuffled over three epochs, and class-weighted), bit for bit; the
  synthetic face tree and ``NpyFolderDataset`` items equal JAX's.
* ``TrainLoop`` on stub steps (deterministic losses and probabilities from
  the batch): the same epoch history as the JAX loop (losses, both metric
  variants, eval scores, plateau LR), the same best epochs and the same
  early stop; the feature-caching loaders replay what the JAX ones do.
* ``cli/train_visual.py`` on the CPU, 2 epochs at 32^2 (one frozen, one
  not), plain and with ``--cache_features true --shuffle false``: its best
  bundle loads in the JAX package's ``VisualScorer.from_bundle`` and scores
  the eval clips within the serving tests' fp32 bar (atol 1e-4) of the
  port's scorer, and the port's scores are within the same bar of the
  trainer's eval probabilities of the best epoch (unfolded against folded).
  The dataset-mode flags (``--mode fakeavceleb|lavdf|lavdf_raw`` and
  theirs) build loaders whose batches are the JAX CLI's; flags whose piece
  is not ported raise, as does ``--device cuda`` where there is no CUDA.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_deepfake_detection_tpu.core.checkpoint import load_bundle
from multimodal_deepfake_detection_tpu.data import DataLoader as JDataLoader
from multimodal_deepfake_detection_tpu.data import NpyFolderDataset as JDataset
from multimodal_deepfake_detection_tpu.data import make_face_npy_tree as j_make_tree
from multimodal_deepfake_detection_tpu.models import heads as jheads
from multimodal_deepfake_detection_tpu.models import serve as jserve
from multimodal_deepfake_detection_tpu.train import PlateauScheduler as JPlateau
from multimodal_deepfake_detection_tpu.train import TrainLoop as JLoop
from multimodal_deepfake_detection_tpu.train import TrainState as JState
from multimodal_deepfake_detection_tpu.train import make_optimizer as j_make_optimizer
from multimodal_deepfake_detection_tpu_torch.cli import serve as tcli
from multimodal_deepfake_detection_tpu_torch.cli import train_visual as tv
from multimodal_deepfake_detection_tpu_torch.data.datasets import NpyFolderDataset
from multimodal_deepfake_detection_tpu_torch.data.loader import DataLoader
from multimodal_deepfake_detection_tpu_torch.data.synthetic import make_face_npy_tree
from multimodal_deepfake_detection_tpu_torch.models.serve import VisualScorer
from multimodal_deepfake_detection_tpu_torch.train import PlateauScheduler, TrainLoop, TrainState
from multimodal_deepfake_detection_tpu_torch.train import make_optimizer

SCORE_TOL = dict(rtol=0, atol=1e-4)


class _Items:
    def __init__(self, n=11, seed=0):
        rng = np.random.default_rng(seed)
        self.items = [(rng.normal(0, 1, (int(rng.integers(1, 8)), 2)).astype(np.float32), i % 3 == 0)
                      for i in range(n)]
        self.all_labels = [int(y) for _, y in self.items]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("kw", [dict(shuffle=True), dict(weighted=True)], ids=["shuffle", "weighted"])
def test_dataloader_batches_match_jax(kw):
    ds = _Items()
    common = dict(batch_size=3, seed=5, buckets=(4, 8), **kw)
    ours, theirs = DataLoader(ds, **common), JDataLoader(ds, **common)
    assert len(ours) == len(theirs) == 4
    for _ in range(3):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)


def test_synthetic_tree_and_dataset_match_jax(tmp_path):
    make_face_npy_tree(str(tmp_path / "t"), n_per_class=2, frames=3, size=8, seed=4)
    j_make_tree(str(tmp_path / "j"), n_per_class=2, frames=3, size=8, seed=4)
    for split in ("train", "eval", "test"):
        ours = NpyFolderDataset(str(tmp_path / "t" / split), max_frames=2)
        theirs = JDataset(str(tmp_path / "j" / split), max_frames=2)
        assert [os.path.basename(f) for f in ours.files] == [os.path.basename(f) for f in theirs.files]
        assert ours.all_labels == theirs.all_labels and ours.class_counts() == theirs.class_counts()
        for i in range(len(ours)):
            (x, y), (xj, yj) = ours[i], theirs[i]
            assert y == yj and x.dtype == xj.dtype and np.array_equal(x, xj)


EVAL_LOSS = [1.0, 0.8, 0.85, 0.86, 0.7, 0.9, 0.95, 0.99, 1.2, 1.3]


def _stubs(to_array, opt_state_of):
    """Deterministic steps from the batch: the loss from the batch mean and
    the epoch, the probabilities a squashed per-clip mean."""
    calls = {"eval": 0}

    def probs_of(batch):
        return 1 / (1 + np.exp(-4 * batch.reshape(batch.shape[0], -1).mean(1)))

    def train_step(state, batch, rng_seed, epoch):
        x, labels, lengths = batch
        return state, to_array(np.float32(x.mean() + 1.0 / (epoch + 1))), to_array(probs_of(x))

    def eval_step(state, batch):
        x, labels, lengths = batch
        calls["eval"] += 1
        return to_array(np.float32(EVAL_LOSS[(calls["eval"] - 1) // 4] + 1e-3 * x.mean())), \
            to_array(probs_of(x))

    return train_step, eval_step


@pytest.mark.parametrize("variant", ["basic", "interp"])
def test_train_loop_history_matches_jax(variant):
    ds = _Items(14, seed=1)
    runs = {}
    for name in ("port", "jax"):
        if name == "port":
            toy = torch.nn.Linear(2, 1)
            state = TrainState(0, toy, make_optimizer(toy.parameters(), "adam", 1e-3))
            Loader, Loop, Plateau, to_array = DataLoader, TrainLoop, PlateauScheduler, torch.tensor
        else:
            params = {"w": jnp.zeros(2)}
            tx = j_make_optimizer("adam", 1e-3)
            state = JState(jnp.zeros((), jnp.int32), params, {}, tx.init(params))
            Loader, Loop, Plateau, to_array = JDataLoader, JLoop, JPlateau, jnp.asarray
        train_step, eval_step = _stubs(to_array, None)
        best = []
        loop = Loop(train_step=train_step, eval_step=eval_step, state=state,
                    train_loader=Loader(ds, 4, shuffle=True, seed=2, buckets=(8,)),
                    eval_loader=Loader(ds, 4, buckets=(8,)), num_epochs=len(EVAL_LOSS),
                    early_stop_patience=4, plateau=Plateau(1e-3, factor=0.5, patience=1),
                    best_policy="loss_and_eer", on_best=lambda s, r: best.append(r.epoch),
                    metrics_variant=variant, log=lambda s: None, seed=3)
        runs[name] = (loop.run(), best)
    (ours, best_t), (theirs, best_j) = runs["port"], runs["jax"]
    assert best_t == best_j and len(ours) == len(theirs) < len(EVAL_LOSS)  # stopped early
    for a, b in zip(ours, theirs):
        assert a.epoch == b.epoch and a.lr == b.lr
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=1e-6)
        np.testing.assert_allclose(a.eval_loss, b.eval_loss, rtol=1e-6)
        for k in b.eval_metrics:
            np.testing.assert_allclose(a.eval_metrics[k], b.eval_metrics[k], rtol=1e-6, err_msg=k)
            np.testing.assert_allclose(a.train_metrics[k], b.train_metrics[k], rtol=1e-6)
        assert np.array_equal(a.eval_scores[0], b.eval_scores[0])
        np.testing.assert_allclose(a.eval_scores[1], b.eval_scores[1], rtol=1e-6)
    assert ours[-1].lr < 1e-3


def test_feature_caching_loaders_match_jax():
    from multimodal_deepfake_detection_tpu.train import feature_cache as jfc
    from multimodal_deepfake_detection_tpu_torch.train import feature_cache as tfc

    ds = _Items(7, seed=4)
    feat = lambda x: np.tanh(x) * 2
    calls = {"port": 0, "jax": 0}
    runs = {}
    for name, mod, Loader in (("port", tfc, DataLoader), ("jax", jfc, JDataLoader)):
        def counted(x, name=name):
            calls[name] += 1
            return feat(x)
        with pytest.raises(ValueError):
            mod.FeatureCachingLoader(Loader(ds, 3, shuffle=True), counted)
        cached = mod.FeatureCachingLoader(Loader(ds, 3, buckets=(8,)), counted,
                                          dtype=np.float16)
        ctr = mod._EpochCounter()
        train = mod.PhaseSwitchLoader(Loader(ds, 3, buckets=(8,)), counted, switch_epoch=2,
                                      counter=ctr, role="train")
        evals = mod.PhaseSwitchLoader(Loader(ds, 2, buckets=(8,)), counted, switch_epoch=2,
                                      counter=ctr, role="eval")
        out = []
        for _ in range(3):
            out += list(cached) + list(train) + list(evals)
        runs[name] = out
    assert calls["port"] == calls["jax"] == 3 + 3 + 4  # each loader's cache filled once
    assert len(runs["port"]) == len(runs["jax"])
    for a, b in zip(runs["port"], runs["jax"]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.fixture
def one_torch_thread():
    """torch on one intra-op thread for the CLI runs, restored after: the
    full-width model's small convolutions gain nothing from several
    threads, which only contend with the other test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("faces")
    return make_face_npy_tree(str(root), n_per_class=1, frames=3, size=32, seed=0)


_JAX_INIT = jheads.xception_lstm_init


@functools.lru_cache(maxsize=None)
def _template_shapes(hidden_dim):
    return jax.eval_shape(lambda r: _JAX_INIT(r, hidden_dim), jax.random.PRNGKey(0))


@pytest.fixture
def jax_from_bundle(monkeypatch):
    """The JAX ``VisualScorer.from_bundle`` with a template tree of zeros of
    ``xception_lstm_init``'s shapes in place of its random one (drawing 20 M
    normals takes about 10 s on a CPU). The loader merges the bundle's
    params strictly and its state over the template's: the port's bundle
    holds every leaf of both, so no template value survives."""
    def zeros_init(rng, hidden_dim):
        return jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype),
                                      _template_shapes(hidden_dim))

    monkeypatch.setattr(jheads, "xception_lstm_init", zeros_init)
    return jserve.VisualScorer.from_bundle


def _train(tree, ckdir, *extra):
    logs = []
    history = tv.main(["--train_folder", f"{tree}/train", "--eval_folder", f"{tree}/eval",
                       "--checkpoint_dir", ckdir, "--epochs", "2", "--freeze_epochs", "1",
                       "--batch_size", "2", "--buckets", "4", "--eval_with_margin", "false",
                       "--compute_dtype", "float32", "--device", "cpu", *extra], log=logs.append)
    # the epoch whose eval saved the bundle last: its log line follows the save's
    saves = [i for i, line in enumerate(logs) if line.startswith("new best model saved")]
    epoch_lines = [i for i, line in enumerate(logs) if line.startswith("epoch ")]
    best_epoch = next(k for k, i in enumerate(epoch_lines) if i > saves[-1])
    return history, best_epoch


def _leaves(tree):
    return sorted(jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("extra", [(), ("--cache_features", "true", "--shuffle", "false")],
                         ids=["plain", "cache_features"])
def test_train_visual_cli_bundle_serves_in_both_packages(tree, tmp_path, extra, jax_from_bundle,
                                                         one_torch_thread):
    history, best_epoch = _train(tree, str(tmp_path), *extra)
    assert len(history) == 2 and all(np.isfinite(r.train_loss) for r in history)
    bundle = str(tmp_path / tv.Config.bundle_name)
    assert os.path.exists(bundle) and os.path.exists(tmp_path / "train_visual_state.pt")
    saved, template = load_bundle(bundle), _template_shapes(128)
    assert _leaves(saved["model"]) == _leaves(template[0])
    assert _leaves(saved["state"]) == _leaves(template[1])

    files = sorted(f for f in os.listdir(f"{tree}/eval"))
    clips = [np.load(f"{tree}/eval/{f}") for f in files]
    batch, lengths = tcli._pad_stack(clips)
    jsc = jax_from_bundle(bundle, compute_dtype=jnp.float32, use_pallas=False, buckets=(4,))
    tsc = VisualScorer.from_bundle(bundle, compute_dtype=torch.float32, device="cpu",
                                   buckets=(4,))
    ours = tsc.score(batch, lengths)
    np.testing.assert_allclose(ours, jsc.score(batch, lengths), **SCORE_TOL)
    labels, probs = history[best_epoch].eval_scores
    assert list(labels) == [0 if f.startswith("real") else 1 for f in files]
    np.testing.assert_allclose(ours, probs, **SCORE_TOL)


@pytest.fixture(scope="module")
def video_tree(tmp_path_factory):
    """Six MJPEG clips (cv2) with their frames as ``<file>.npy``, a LAV-DF
    metadata.json (train 4, dev 2) and a FakeAVCeleb ``path,label,split``
    csv over the npy copies."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(12)
    meta, rows = [], ["path,label,split"]
    for i, split in enumerate(("train",) * 4 + ("dev",) * 2):
        frames = rng.integers(0, 256, (3 + i % 3, 40, 48, 3), np.uint8)
        name = f"v{i}.avi"
        w = cv2.VideoWriter(str(root / name), cv2.VideoWriter_fourcc(*"MJPG"), 10, (48, 40))
        for f in frames:
            w.write(f)
        w.release()
        np.save(root / f"{name}.npy", frames)
        meta.append({"file": name, "split": split, "n_fakes": i % 2})
        rows.append(f"{name}.npy,{'fake' if i % 2 else 'real'},{split}")
    (root / "metadata.json").write_text(json.dumps(meta))
    (root / "meta.csv").write_text("\n".join(rows))
    return str(root)


@pytest.mark.parametrize("argv", [
    ["--mode", "fakeavceleb", "--csv_path", "meta.csv", "--augment_minority", "true"],
    ["--mode", "lavdf", "--lavdf_json", "metadata.json", "--sample_percentage", "0.5"],
    ["--mode", "lavdf_raw", "--lavdf_json", "metadata.json", "--use_face_detection", "true"],
    ["--mode", "lavdf_raw", "--lavdf_json", "metadata.json", "--num_workers", "2"],
    ["--mode", "lavdf_raw", "--lavdf_json", "metadata.json", "--frame_size", "24,16"],
])
def test_video_flags_build(argv, video_tree):
    """The dataset-mode flags build the CLI: its train and eval loaders yield
    the batches of the JAX CLI's (``get_face_dataloader`` with the arguments
    its ``build`` passes), bit for bit."""
    from multimodal_deepfake_detection_tpu.data.video_enhanced import get_face_dataloader

    argv = [os.path.join(video_tree, a) if a.endswith((".csv", ".json")) else a for a in argv]
    config = tv.parse_config(tv.Config, argv + [
        "--train_folder", video_tree, "--eval_folder", video_tree, "--max_frames", "4",
        "--buckets", "4", "--batch_size", "2", "--hidden_dim", "4", "--device", "cpu"],
        prog="train_visual")
    train_loader, eval_loader, state, _, _ = tv.build(config)
    assert state.step == 0
    common = dict(mode=config.mode, csv_path=config.csv_path, lavdf_json=config.lavdf_json,
                  batch_size=2, use_face_detection=config.use_face_detection,
                  frame_size=tuple(config.frame_size), max_frames=4, buckets=(4,),
                  seed=config.seed, num_workers=config.num_workers)
    want = (get_face_dataloader(video_tree, subset="train", shuffle=config.shuffle,
                                augment_minority=config.augment_minority,
                                sample_percentage=config.sample_percentage, **common),
            get_face_dataloader(video_tree, subset="eval", **common))
    for got, ref in zip((train_loader, eval_loader), want):
        pairs = list(zip(got, ref))
        assert len(pairs) == len(ref) > 0
        for g, r in pairs:
            for a, b in zip(g, r):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("argv,err", [
    (["--ckpt_backend", "orbax"], NotImplementedError),  # ROADMAP item 11
    (["--cache_features", "true"], ValueError),  # shuffles by default
    (["--mode", "csv"], ValueError),
])
def test_unported_flags_raise(argv, err):
    with pytest.raises(err):
        tv.build(tv.parse_config(tv.Config, argv + ["--device", "cpu"], prog="train_visual"))


def test_missing_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tv.build(tv.Config())
