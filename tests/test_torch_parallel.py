"""The port's meshes, placements and sharded engines, in one process.

``parallel/mesh.py``: ``auto_data_mesh``'s gcd rule against JAX's, and
``shard_batch``'s row blocks against JAX's ``P("data")`` shards on the
8-device virtual CPU mesh (``tests/conftest.py``). ``parallel/sharding.py``:
``param_placements`` against ``param_shardings`` on the flagship tree, leaf
for leaf through the weight bridge's names and layouts. Every engine with
``mesh=[cpu, cpu]`` and ``[cpu, cpu, cpu]`` at an odd B (pad rows) against
the same engine unsharded, fp32, rtol 1e-5 / atol 1e-6; the AV pair also
against the JAX ``AVScorer`` sharded over 3 virtual devices; ``cli/serve.py
--use_mesh`` on one device, which scores unsharded; ``test_visual`` and
``test_av_fused`` with their batches sharded over ``[cpu, cpu]``.
"""
import os

import numpy as np
import pytest
import torch

from multimodal_deepfake_detection_tpu_torch.models.au_face import AUFaceDetector
from multimodal_deepfake_detection_tpu_torch.models.heads import XceptionLSTM, XceptionLSTMArcFace
from multimodal_deepfake_detection_tpu_torch.models.resnet_lstm import AUPatchClassifier
from multimodal_deepfake_detection_tpu_torch.models.serve import (
    AudioScorer,
    AUFaceScorer,
    AUPatchScorer,
    AVScorer,
    VisualScorer,
)
from multimodal_deepfake_detection_tpu_torch.parallel import (
    auto_data_mesh,
    data_sharding,
    shard_batch,
)
from multimodal_deepfake_detection_tpu_torch.parallel.sharding import param_placements
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights

CPU = torch.device("cpu")
HIDDEN = 8
BAR = dict(rtol=1e-5, atol=1e-6)
F32 = dict(compute_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module, its fixtures included: beside
    the other test workers, more threads oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def test_auto_data_mesh_gcd_rule():
    import jax

    from multimodal_deepfake_detection_tpu.parallel import auto_data_mesh as jax_auto

    devices = [CPU] * len(jax.devices())
    for B in (1, 2, 3, 4, 6, 7, 8, 12):
        got, want = auto_data_mesh(B, devices=devices), jax_auto(B)
        assert (got is None) == (want is None), B
        if got is not None:
            assert len(got) == want.devices.size, B
    assert auto_data_mesh(4, devices=[CPU]) is None
    with pytest.raises(ValueError, match="do not divide"):
        data_sharding(3, 8)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_batch_blocks_match_jax(n):
    import jax

    from multimodal_deepfake_detection_tpu.parallel import make_mesh, shard_batch as jax_shard

    arr = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    devices = jax.devices()[:n]
    placed = jax_shard(make_mesh(devices=devices), arr)
    by_device = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    got = shard_batch([CPU] * n, (arr, None))
    assert len(got) == n
    for d, (block, none) in zip(devices, got):
        assert none is None
        np.testing.assert_array_equal(block.numpy(), by_device[d])


def test_param_placements_match_jax_param_shardings():
    """The same flagship leaves split over ``model`` as in JAX, each on the
    dim that the bridge's layout change maps JAX's onto."""
    import jax
    from jax.sharding import Mesh

    from multimodal_deepfake_detection_tpu.parallel.sharding import param_shardings

    model = XceptionLSTMArcFace(16, generator=torch.Generator().manual_seed(0))
    params, _ = jax_weights.xception_lstm_to_jax(model)
    params["arcface"] = jax_weights.arcface_to_jax(model.arcface)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
    specs = param_shardings(mesh, params)
    placements = param_placements(model, 2)
    names = {id(p): n for n, p in model.named_parameters()}
    leaves = list(jax_weights._xception_lstm_leaves(model)) + [
        (tree, ("arcface",) + path, t, kind)
        for tree, path, t, kind in jax_weights._arcface_leaves(model.arcface)]
    # torch dim -> JAX dim of each layout (utils/jax_weights.py)
    to_jax = {"conv": {0: 3, 1: 2, 2: 0, 3: 1}, "linear": {0: 1, 1: 0}, "plain": {0: 0, 1: 1}}
    n_split = 0
    for tree, path, t, kind in leaves:
        if tree != "params":
            continue
        spec = specs
        for k in path:
            spec = spec[k]
        jax_dim = next((i for i, a in enumerate(spec.spec) if a == "model"), None)
        placement = placements[names[id(t)]]
        torch_dim = placement.dim if placement.is_shard() else None
        assert (None if torch_dim is None else to_jax[kind][torch_dim]) == jax_dim, path
        n_split += jax_dim is not None
    assert n_split > 100  # the convs, their BNs, the tower and w_ih


# ---------------------------------------------------------------------------
# Sharded engines
# ---------------------------------------------------------------------------

def _rng(seed):
    return np.random.default_rng(seed)


def _visual(**kw):
    model = XceptionLSTMArcFace(HIDDEN, generator=torch.Generator().manual_seed(0))
    return lambda mesh: VisualScorer(model, model.arcface, mesh=mesh, **F32, **kw)


def _audio():
    model = XceptionLSTM(HIDDEN, generator=torch.Generator().manual_seed(1))
    return lambda mesh: AudioScorer(model, mesh=mesh, **F32)


def _au_face():
    model = AUFaceDetector(4, generator=torch.Generator().manual_seed(2))
    return lambda mesh: AUFaceScorer(model, mesh=mesh, **F32)


def _au_patch():
    model = AUPatchClassifier(8, 4, generator=torch.Generator().manual_seed(3))
    return lambda mesh: AUPatchScorer(model, mesh=mesh, **F32)


B = 5
ENGINES = {
    "visual": (_visual, lambda: ((_rng(0).random((B, 2, 32, 32, 3)) * 255).astype(np.uint8),
                                 np.array([2, 1, 2, 2, 1], np.int32))),
    "visual_w8a8": (lambda: _visual(quantize="w8a8"),
                    lambda: ((_rng(1).random((B, 2, 32, 32, 3)) * 255).astype(np.uint8),)),
    "audio": (_audio, lambda: (_rng(2).normal(0, 0.1, (B, 1600)).astype(np.float32),)),
    "au_face": (_au_face, lambda: (_rng(3).integers(0, 255, (B, 2, 16, 16, 3), np.uint8),
                                   _rng(4).integers(0, 255, (B, 2, 2, 16, 16, 3), np.uint8))),
    "au_patch": (_au_patch, lambda: (_rng(5).integers(0, 255, (B, 2, 2, 16, 16, 3), np.uint8),
                                     None, np.array([2, 1, 2, 1, 2]))),
}


@pytest.fixture(scope="module")
def engines():
    """name -> (build(mesh), inputs, unsharded scores)."""
    out = {}
    for name, (make, inputs) in ENGINES.items():
        build, args = make(), inputs()
        out[name] = (build, args, build(None).score(*args))
    return out


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("name", list(ENGINES))
def test_sharded_engine_matches_unsharded(engines, name, n):
    build, args, want = engines[name]
    scorer = build([CPU] * n)
    got = scorer.score(*args)
    assert got.shape == (B,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **BAR)
    assert len(scorer._replicas()) == n  # one replica a device, built once


def test_sharded_av_matches_jax_sharded_av():
    """The port's AV pair over ``[cpu] * 3`` against the JAX ``AVScorer``
    over 3 virtual devices, from the same weights, and against the port's
    unsharded pair."""
    import jax
    import jax.numpy as jnp

    from multimodal_deepfake_detection_tpu.models import serve as jserve
    from multimodal_deepfake_detection_tpu.parallel import make_mesh

    visual = XceptionLSTMArcFace(HIDDEN, generator=torch.Generator().manual_seed(0))
    audio = XceptionLSTM(HIDDEN, generator=torch.Generator().manual_seed(1))
    frames = (_rng(6).random((3, 2, 32, 32, 3)) * 255).astype(np.uint8)
    waves = _rng(7).normal(0, 0.1, (3, 1600)).astype(np.float32)

    def port(mesh):
        return AVScorer(VisualScorer(visual, visual.arcface, mesh=mesh, **F32),
                        AudioScorer(audio, mesh=mesh, **F32)).score(frames, waves)

    got = port([CPU] * 3)
    np.testing.assert_allclose(got, port(None), **BAR)
    vp, vs = jax_weights.xception_lstm_to_jax(visual)
    vp["arcface"] = jax_weights.arcface_to_jax(visual.arcface)
    ap, as_ = jax_weights.xception_lstm_to_jax(audio)
    mesh = make_mesh(devices=jax.devices()[:3])
    kw = dict(compute_dtype=jnp.float32, use_pallas=False, mesh=mesh)
    ref = jserve.AVScorer(jserve.VisualScorer(vp, vs, **kw),
                          jserve.AudioScorer(ap, as_, **kw)).score(frames, waves)
    np.testing.assert_allclose(got, ref, **BAR)


def test_serve_cli_use_mesh_on_one_device(tmp_path):
    """``--use_mesh true`` with one device scores unsharded, says so, and
    gives the same scores."""
    from multimodal_deepfake_detection_tpu_torch.cli import serve
    from multimodal_deepfake_detection_tpu_torch.cli.train_visual import save_visual_bundle

    model = XceptionLSTMArcFace(HIDDEN, generator=torch.Generator().manual_seed(0))
    bundle = str(tmp_path / "v.npz")
    save_visual_bundle(bundle, model)
    clips = tmp_path / "clips"
    clips.mkdir()
    for i in range(3):
        np.save(clips / f"c{i}.npy", _rng(10 + i).integers(0, 255, (2, 32, 32, 3), np.uint8))
    argv = ["--engine", "visual", "--ckpt_path", bundle, "--hidden_dim", str(HIDDEN),
            "--input", str(clips), "--device", "cpu", "--compute_dtype", "float32",
            "--batch_size", "4"]
    runs = []
    for extra in ([], ["--use_mesh", "true"]):
        logs = []
        serve.main(argv + extra, log=logs.append)
        runs.append(logs)
    assert any("scoring unsharded" in line for line in runs[1])
    scores = [[ln for ln in logs if ln.startswith("{")] for logs in runs]
    assert scores[0] == scores[1] and len(scores[0]) == 3
    with pytest.raises(ValueError, match="--artifact"):
        serve.main(argv + ["--use_mesh", "true", "--artifact", os.fspath(tmp_path)], log=print)


def test_eval_clis_shard_batches_over_a_device_list(tmp_path):
    """``test_visual`` and ``test_av_fused`` over ``[cpu, cpu]``: each batch
    split, scored on two replicas and gathered in order, the scores those of
    one device."""
    from multimodal_deepfake_detection_tpu_torch.cli import test_av_fused as tav
    from multimodal_deepfake_detection_tpu_torch.cli import test_visual as ttv
    from multimodal_deepfake_detection_tpu_torch.cli.train_visual import save_visual_bundle
    from multimodal_deepfake_detection_tpu_torch.core.config import parse_config
    from multimodal_deepfake_detection_tpu_torch.data.synthetic import (
        make_audio_npy_tree,
        make_face_npy_tree,
    )

    faces = make_face_npy_tree(str(tmp_path / "faces"), n_per_class=3, frames=3, size=32)
    mfcc = make_audio_npy_tree(str(tmp_path / "mfcc"), n_per_class=3, frames=5)
    visual = XceptionLSTMArcFace(HIDDEN, generator=torch.Generator().manual_seed(0))
    save_visual_bundle(str(tmp_path / "v.npz"), visual)
    jax_weights.save_audio_bundle(str(tmp_path / "a.npz"),
                                  XceptionLSTM(HIDDEN, generator=torch.Generator().manual_seed(1)))
    common = ["--device", "cpu", "--compute_dtype", "float32", "--batch_size", "4"]
    cfg = parse_config(ttv.Config, common + [
        "--test_folder", f"{faces}/test", "--ckpt_path", str(tmp_path / "v.npz"),
        "--hidden_dim", str(HIDDEN), "--buckets", "4"], prog="test_visual")
    loader = ttv.make_loader(cfg)
    runs = [ttv.evaluate(ttv.build_scorer(cfg, devices=d), loader)[1:] for d in (None, [CPU] * 2)]
    assert len(runs[0][0]) == 6
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
    np.testing.assert_allclose(runs[1][1], runs[0][1], **BAR)

    cfg = parse_config(tav.Config, common + [
        "--video_folder", f"{faces}/test", "--audio_folder", f"{mfcc}/test",
        "--visual_ckpt", str(tmp_path / "v.npz"), "--audio_ckpt", str(tmp_path / "a.npz"),
        "--visual_hidden", str(HIDDEN), "--audio_hidden", str(HIDDEN), "--video_buckets", "4",
        "--audio_buckets", "5"], prog="test_av_fused")
    loader = tav.make_loader(cfg, log=lambda s: None)
    logs = []
    sharded = tav.build_scorer(cfg, devices=[CPU] * 2, log=logs.append)
    assert logs == ["sharded AV eval over 2 devices"]
    runs = [tav.evaluate(s, loader) for s in (tav.build_scorer(cfg), sharded)]
    np.testing.assert_array_equal(runs[1][0], runs[0][0])
    for got, want in zip(runs[1][1:], runs[0][1:]):
        np.testing.assert_allclose(got, want, **BAR)
