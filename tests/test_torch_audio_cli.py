"""``cli/serve.py --engine audio`` and ``--engine av`` against the JAX CLI,
fp32 on the CPU.

The same JAX-format bundles (an XceptionLSTMA and an XceptionLSTMV +
ArcFace, hidden 8, randomised BN statistics) and the same inputs in a temp
dir go through both CLIs: ``.npy`` waveforms and an int16 ``.wav`` for
audio; ``.npy`` clips paired by stem with ``.wav`` (before ``.npy``) and
``.npy`` waveforms for AV. A batch of waveforms is zero-padded to its
longest and scored without sample lengths on both sides, as the JAX CLI
does. Bound: the JSONL scores atol 1e-4 (rounded to 6 places by both).
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from scipy.io import wavfile  # noqa: E402

from multimodal_deepfake_detection_tpu.cli import serve as jcli  # noqa: E402
from multimodal_deepfake_detection_tpu.core.checkpoint import save_bundle  # noqa: E402
from multimodal_deepfake_detection_tpu.models.heads import (  # noqa: E402
    arcface_init,
    xception_lstm_init,
)
from multimodal_deepfake_detection_tpu_torch.cli import serve as tcli  # noqa: E402

from test_torch_serve import _randomize_bn  # noqa: E402

FLAGS = ["--batch_size", "2", "--compute_dtype", "float32", "--hidden_dim", "8",
         "--audio_hidden", "8", "--sample_buckets", "3200", "--buckets", "4"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    for name, key in (("audio", 21), ("visual", 22)):
        params, state = np_tree(xception_lstm_init(jax.random.PRNGKey(key), 8))
        _randomize_bn(params["backbone"], state["backbone"], np.random.default_rng(key))
        trees = {"model": params, "state": state}
        if name == "visual":
            trees["arcface"] = np_tree(arcface_init(jax.random.PRNGKey(23), 8, 2))
        save_bundle(str(root / f"{name}.npz"), trees)
    rng = np.random.default_rng(24)
    waves, clips = root / "waves", root / "clips"
    waves.mkdir()
    clips.mkdir()
    for stem, L in (("c0", 1733), ("c1", 1600), ("c2", 2400)):
        np.save(waves / f"{stem}.npy", rng.normal(0, 0.1, L).astype(np.float32))
        np.save(clips / f"{stem}.npy", rng.integers(0, 255, (3, 32, 32, 3), np.uint8))
    pcm = (rng.normal(0, 0.1, (1900, 2)) * 32768).clip(-32768, 32767).astype(np.int16)
    wavfile.write(str(waves / "c0.wav"), 16000, pcm)  # stereo; paired before c0.npy
    return root


def _scores(main, argv, out):
    n = main(argv + ["--output", str(out)], log=lambda s: None)
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert n == len(recs)
    return [r["path"] for r in recs], np.array([r["score"] for r in recs]), recs


def _both(inputs, argv, monkeypatch, tag):
    monkeypatch.setenv("MDD_NO_COMPILE_CACHE", "1")
    ref = _scores(jcli.main, argv, inputs / f"jax_{tag}.jsonl")
    got = _scores(tcli.main, argv + ["--device", "cpu"], inputs / f"port_{tag}.jsonl")
    return got, ref


def test_cli_audio_matches_jax_cli(inputs, monkeypatch):
    argv = ["--engine", "audio", "--ckpt_path", str(inputs / "audio.npz"),
            "--input", str(inputs / "waves")] + FLAGS
    (paths, got, recs), (ref_paths, ref, _) = _both(inputs, argv, monkeypatch, "audio")
    assert paths == ref_paths and [p.rsplit("/", 1)[-1] for p in paths] == [
        "c0.npy", "c0.wav", "c1.npy", "c2.npy"]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert all(r["fake"] == (r["score"] > 0.5) for r in recs)


def test_cli_av_matches_jax_cli(inputs, monkeypatch):
    argv = ["--engine", "av", "--ckpt_path", str(inputs / "visual.npz"),
            "--audio_ckpt_path", str(inputs / "audio.npz"), "--input", str(inputs / "clips"),
            "--audio_input", str(inputs / "waves"), "--av_alpha", "0.3"] + FLAGS
    (paths, got, _), (ref_paths, ref, _) = _both(inputs, argv, monkeypatch, "av")
    assert paths == ref_paths and len(paths) == 3
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_load_waveform_matches_jax(inputs):
    for name in ("c0.wav", "c1.npy"):
        path = str(inputs / "waves" / name)
        got, ref = tcli._load_waveform(path), jcli._load_waveform(path)
        assert got.dtype == np.float32 and got.ndim == 1
        np.testing.assert_array_equal(got, ref)


def test_cli_av_refusals(inputs):
    base = ["--engine", "av", "--ckpt_path", str(inputs / "visual.npz"),
            "--input", str(inputs / "clips"), "--device", "cpu"] + FLAGS
    with pytest.raises(ValueError, match="--audio_ckpt_path"):
        tcli.main(base, log=lambda s: None)
    with pytest.raises(ValueError, match="--audio_input"):
        tcli.main(base + ["--audio_ckpt_path", str(inputs / "audio.npz")], log=lambda s: None)
    with pytest.raises(ValueError, match="unknown engine"):
        tcli.build_engine(tcli.parse_config(["--engine", "daemon", "--device", "cpu"]))
