"""The port's online serving (``serving/``, ``cli/serve_daemon.py``) on the CPU.

The contract of the JAX package's ``tests/test_serving_daemon.py`` on the
port's copy: the micro-batcher's coalescing, shape keys, batch buckets,
engine-aware deadlines and error handling with a fake adapter; coalesced
batches of the port's engines score what each clip scores alone: bit-equal
through the audio and AU-patch adapters; through the visual one within
atol 1e-6 (``SOLO_TOL``; reading max |d| 4.4e-11, 9.1e-7 relative), where
the backbone's per-frame features are bit-equal and the LSTM's ``(B, H) @
(H, 4H)`` matmuls round differently at B = 1 than at B = 4 (the CPU BLAS
takes another kernel); the
daemon speaks JSON and npz; ``cli/serve_daemon.py`` serves a checkpoint and
the artifact ``cli/export_serving.py`` writes from it, through its
``started`` hook; and one request stream through the JAX daemon and the
port's daemon, over the same weights, agrees within atol 1e-4.

Small sizes: frames of 32^2, T <= 4, hidden 8, fp32.
"""
import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from multimodal_deepfake_detection_tpu_torch.cli import export_serving, serve_daemon
from multimodal_deepfake_detection_tpu_torch.core.checkpoint import save_bundle
from multimodal_deepfake_detection_tpu_torch.models.heads import ArcFace, XceptionLSTM
from multimodal_deepfake_detection_tpu_torch.models.resnet_lstm import AUPatchClassifier
from multimodal_deepfake_detection_tpu_torch.models.serve import (
    AudioScorer,
    AUPatchScorer,
    VisualScorer,
)
from multimodal_deepfake_detection_tpu_torch.serving import (
    AudioAdapter,
    AUPatchAdapter,
    MicroBatcher,
    ServingDaemon,
    VisualAdapter,
)
from multimodal_deepfake_detection_tpu_torch.serving.batcher import EngineAdapter
from multimodal_deepfake_detection_tpu_torch.utils.jax_weights import (
    arcface_to_jax,
    xception_lstm_to_jax,
)

RNG = np.random.default_rng(0)
HIDDEN, SIZE = 8, 32
F32 = dict(compute_dtype=torch.float32, device="cpu")
SOLO_TOL = dict(rtol=0, atol=1e-6)  # a visual clip in a coalesced batch against alone


class _FakeAdapter(EngineAdapter):
    """Sums each item's array; records batch shapes. No engine involved."""

    name = "fake"
    fields = {"x": (np.float32, 1)}

    def __init__(self, fail_on_nan: bool = False):
        self.batches = []  # (n_items, pad_to, shape_key)
        self.fail_on_nan = fail_on_nan
        self._lock = threading.Lock()

    def shape_key(self, item):
        return item["x"].shape

    def run(self, items, pad_to):
        with self._lock:
            self.batches.append((len(items), pad_to, items[0]["x"].shape))
        out = np.array([float(it["x"].sum()) for it in items])
        if self.fail_on_nan and np.any(np.isnan(out)):
            raise RuntimeError("poison item")
        time.sleep(0.01)  # give later submits a chance to coalesce
        return out


class _SlowAdapter(_FakeAdapter):
    """The engine stays busy ``busy_s`` per batch; records when each ran."""

    def __init__(self, busy_s: float):
        super().__init__()
        self.busy_s, self.t_runs = busy_s, []

    def run(self, items, pad_to):
        with self._lock:
            self.batches.append((len(items), pad_to, items[0]["x"].shape))
            self.t_runs.append(time.monotonic())
        time.sleep(self.busy_s)
        return np.array([float(it["x"].sum()) for it in items])


def test_microbatcher_coalesces_and_is_exact():
    ad = _FakeAdapter()
    with MicroBatcher(ad, max_batch=8, max_wait_ms=150) as mb:
        xs = [RNG.normal(size=5).astype(np.float32) for _ in range(12)]
        got = [f.result(timeout=10) for f in [mb.submit(x=x) for x in xs]]
    np.testing.assert_allclose(got, [float(x.sum()) for x in xs], rtol=1e-6)
    assert len(ad.batches) < 12  # submitted within the wait window: they coalesce
    assert sum(n for n, _, _ in ad.batches) == 12
    assert all(n <= 8 for n, _, _ in ad.batches)
    st = mb.stats()
    assert st["requests"] == 12 and st["scored"] == 12 and st["errors"] == 0
    assert st["mean_batch_occupancy"] > 1.0


def test_microbatcher_engine_aware_deadline():
    """Items that queued behind a busy engine get a fresh coalescing window
    when it frees: the late pair joins the stragglers, both batches full."""
    ad = _SlowAdapter(0.4)
    xs = [RNG.normal(size=3).astype(np.float32) for _ in range(8)]
    with MicroBatcher(ad, max_batch=4, max_wait_ms=300, batch_buckets=(1, 4)) as mb:
        futs = [mb.submit(x=x) for x in xs[:4]]  # a full batch: busy 0.4 s
        time.sleep(0.1)
        futs += [mb.submit(x=x) for x in xs[4:6]]  # stragglers behind the busy engine

        def late_pair():  # ~0.15 s into the fresh window
            time.sleep(0.45)
            futs.extend(mb.submit(x=x) for x in xs[6:])

        t = threading.Thread(target=late_pair)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        time.sleep(0.05)
        for f in list(futs):
            f.result(timeout=10)
    assert [n for n, _, _ in ad.batches] == [4, 4], ad.batches


def test_microbatcher_shape_key_isolation_and_bucket_padding():
    ad = _FakeAdapter()
    with MicroBatcher(ad, max_batch=8, max_wait_ms=100, batch_buckets=(1, 2, 4, 8)) as mb:
        futs = [mb.submit(x=RNG.normal(size=s).astype(np.float32)) for s in (3, 3, 3, 7)]
        for f in futs:
            f.result(timeout=10)
    assert {shape for _, _, shape in ad.batches} <= {(3,), (7,)}
    assert {shape: n for n, _, shape in ad.batches} == {(3,): 3, (7,): 1}
    assert {shape: pad for _, pad, shape in ad.batches} == {(3,): 4, (7,): 1}


def test_microbatcher_error_propagation_keeps_serving():
    ad = _FakeAdapter(fail_on_nan=True)
    with MicroBatcher(ad, max_batch=4, max_wait_ms=5) as mb:
        with pytest.raises(RuntimeError, match="poison"):
            mb.submit(x=np.array([np.nan], np.float32)).result(timeout=10)
        assert mb.submit(x=np.array([2.0], np.float32)).result(timeout=10) == 2.0
        assert mb.stats()["errors"] == 1


def test_microbatcher_validates_payloads():
    with MicroBatcher(_FakeAdapter(), max_batch=2) as mb:
        with pytest.raises(ValueError, match="missing required"):
            mb.submit()
        with pytest.raises(ValueError, match="unknown fields"):
            mb.submit(x=np.zeros(2, np.float32), y=1)
        with pytest.raises(ValueError, match="dims"):
            mb.submit(x=np.zeros((2, 2), np.float32))


def test_microbatcher_light_traffic_latency_bound():
    """A lone item flushes as a partial batch at about max_wait."""
    ad = _FakeAdapter()
    with MicroBatcher(ad, max_batch=8, max_wait_ms=80, batch_buckets=(1, 8)) as mb:
        t0 = time.monotonic()
        s = mb.score_sync(timeout=10, x=np.ones(3, np.float32))
        dt = time.monotonic() - t0
    assert s == 3.0 and [n for n, _, _ in ad.batches] == [1]
    assert 0.05 <= dt < 1.0, f"lone item took {dt:.3f}s (max_wait 0.08s)"


def test_microbatcher_burst_rump_fresh_window():
    """A burst past max_batch flushes one full batch at once; the rump waits
    a fresh window from engine-free, and the next burst joins it."""
    ad = _SlowAdapter(0.3)
    xs = [RNG.normal(size=3).astype(np.float32) for _ in range(8)]
    with MicroBatcher(ad, max_batch=4, max_wait_ms=250, batch_buckets=(1, 2, 4)) as mb:
        futs = [mb.submit(x=x) for x in xs[:6]]

        def second_burst():
            time.sleep(0.45)
            futs.extend(mb.submit(x=x) for x in xs[6:])

        t = threading.Thread(target=second_burst)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        time.sleep(0.05)
        for f in list(futs):
            f.result(timeout=10)
    assert [n for n, _, _ in ad.batches] == [4, 4], ad.batches
    assert ad.t_runs[1] - ad.t_runs[0] >= 0.3 + 0.1


def test_microbatcher_mixed_engines_concurrent():
    ad_a, ad_b = _FakeAdapter(), _FakeAdapter()
    xs_a = [RNG.normal(size=4).astype(np.float32) for _ in range(10)]
    xs_b = [RNG.normal(size=7).astype(np.float32) for _ in range(10)]
    with MicroBatcher(ad_a, max_batch=4, max_wait_ms=60) as mba, \
            MicroBatcher(ad_b, max_batch=4, max_wait_ms=60) as mbb:
        futs = []
        for xa, xb in zip(xs_a, xs_b):
            futs.append((mba.submit(x=xa), float(xa.sum())))
            futs.append((mbb.submit(x=xb), float(xb.sum())))
        for f, want in futs:
            np.testing.assert_allclose(f.result(timeout=10), want, rtol=1e-6)
    assert sum(n for n, _, _ in ad_a.batches) == sum(n for n, _, _ in ad_b.batches) == 10
    assert {s for _, _, s in ad_a.batches} == {(4,)} and {s for _, _, s in ad_b.batches} == {(7,)}



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module, restored after: in the tier-1 run
    six test workers share the cores, and torch's default of one thread per
    core made these small ops several times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

@pytest.fixture(scope="module")
def model():
    g = torch.Generator().manual_seed(0)
    return XceptionLSTM(HIDDEN, generator=g), ArcFace(HIDDEN, 2, generator=g)


@pytest.fixture(scope="module")
def bundle(model, tmp_path_factory):
    """The model as a JAX-layout ``train_visual`` bundle."""
    path = str(tmp_path_factory.mktemp("bundle") / "visual.npz")
    params, state = xception_lstm_to_jax(model[0])
    save_bundle(path, {"model": params, "state": state, "arcface": arcface_to_jax(model[1])})
    return path


def _clips(lengths, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (t, SIZE, SIZE, 3), dtype=np.uint8) for t in lengths]


def _concurrently(fn, n):
    results = [None] * n
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, fn(i)))
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return results


def test_visual_coalesced_batches_score_as_solo(model):
    served = VisualScorer(*model, buckets=(4,), **F32)
    solo = VisualScorer(*model, buckets=(4,), **F32)
    clips = _clips((2, 3, 4, 3, 2, 4))
    with MicroBatcher(VisualAdapter(served), max_batch=4, max_wait_ms=150,
                      batch_buckets=(1, 2, 4)) as mb:
        got = _concurrently(lambda i: mb.submit(frames=clips[i]).result(timeout=60), len(clips))
        st = mb.stats()
    assert st["scored"] == len(clips) and st["batches"] < len(clips)
    np.testing.assert_allclose(got, [solo.score(c[None])[0] for c in clips], **SOLO_TOL)


def test_audio_adapter_exact_vs_direct(model):
    scorer = AudioScorer(model[0], sample_buckets=(4800,), **F32)
    waves = [RNG.normal(0, 0.1, (n,)).astype(np.float32) for n in (2400, 4000)]
    with MicroBatcher(AudioAdapter(scorer), max_batch=2, max_wait_ms=100) as mb:
        got = [f.result(timeout=60) for f in [mb.submit(waveform=w) for w in waves]]
    np.testing.assert_array_equal(got, [scorer.score(w[None])[0] for w in waves])


def test_au_patch_adapter_exact_vs_direct():
    scorer = AUPatchScorer(AUPatchClassifier(8, 4, generator=torch.Generator().manual_seed(3)),
                           **F32)
    items = [{"patches": RNG.integers(0, 255, (t, 3, 8, 8, 3), np.uint8),
              "weights": RNG.random((t, 3)).astype(np.float32)} for t in (2, 3)]
    with MicroBatcher(AUPatchAdapter(scorer), max_batch=2, max_wait_ms=100) as mb:
        got = [f.result(timeout=60) for f in [mb.submit(**it) for it in items]]
    want = [scorer.score(it["patches"][None], it["weights"][None])[0] for it in items]
    np.testing.assert_array_equal(got, want)


def _post(url, payload, npz=False, timeout=120):
    if npz:
        buf = io.BytesIO()
        np.savez(buf, **payload)
        body, ctype = buf.getvalue(), "application/x-npz"
    else:
        body = json.dumps({k: np.asarray(v).tolist() for k, v in payload.items()}).encode()
        ctype = "application/json"
    req = urllib.request.Request(url, body, {"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def test_daemon_http_json_and_npz(model):
    scorer = VisualScorer(*model, buckets=(4,), **F32)
    clips = _clips((2, 3, 4, 3), seed=2)
    mb = MicroBatcher(VisualAdapter(scorer), max_batch=4, max_wait_ms=60, batch_buckets=(1, 2, 4))
    with ServingDaemon({"visual": mb}, port=0) as d:
        # a burst of clients queues rather than waiting out a SYN retransmit
        assert d._httpd.request_queue_size >= 1024
        assert _get(d.url + "/healthz") == {"ok": True, "engines": ["visual"]}
        code, obj = _post(d.url + "/v1/score/nope", {"frames": clips[0]})
        assert code == 404 and "unknown engine" in obj["error"]
        assert _post(d.url + "/v1/score/visual", {"bogus": [1]})[0] == 400
        res = _concurrently(lambda i: _post(d.url + "/v1/score/visual", {"frames": clips[i]},
                                            npz=i % 2 == 0), len(clips))
        st = _get(d.url + "/v1/stats")["engines"]["visual"]
    for (code, obj), clip in zip(res, clips):
        assert code == 200 and obj["engine"] == "visual", obj
        np.testing.assert_allclose(obj["score"], scorer.score(clip[None])[0], **SOLO_TOL)
    assert st["scored"] == len(clips) and st["errors"] == 0


DAEMON_ARGS = ["--engine", "visual", "--device", "cpu", "--port", "0", "--max_batch", "2",
               "--batch_buckets", "1,2", "--max_wait_ms", "20", "--compute_dtype", "float32"]


def _daemon_scores(argv, clips):
    """Start ``cli/serve_daemon.py`` through its ``started`` hook, score the
    clips over HTTP (npz), stop it."""
    started = []
    serve_daemon.main(argv, log=lambda s: None, started=started)
    (daemon,) = started
    try:
        assert daemon.engines["visual"].stats()["batches"] == 2  # the warm-up, per bucket
        res = _concurrently(lambda i: _post(daemon.url + "/v1/score/visual", {"frames": clips[i]},
                                            npz=True), len(clips))
    finally:
        daemon.stop()
    assert all(code == 200 for code, _ in res), res
    return np.array([obj["score"] for _, obj in res])


def test_serve_daemon_over_a_checkpoint_and_its_artifact(bundle, tmp_path):
    """The CLI daemon over the bundle, then over the artifact
    ``cli/export_serving.py`` writes from it (T = 4, symbolic batch): each
    clip scores as the live scorer scores it alone."""
    clips = _clips((3, 4, 2), seed=3)
    solo = VisualScorer.from_bundle(bundle, hidden_dim=HIDDEN, buckets=(4,), **F32)
    want = [solo.score(c[None])[0] for c in clips]
    live = _daemon_scores(DAEMON_ARGS + ["--ckpt_path", bundle, "--hidden_dim", str(HIDDEN),
                                         "--buckets", "4", "--warmup", "3,32,32"], clips)
    np.testing.assert_allclose(live, want, **SOLO_TOL)
    out = str(tmp_path / "visual_T4.ptprog")
    export_serving.main(["--engine", "visual", "--ckpt_path", bundle, "--hidden_dim",
                         str(HIDDEN), "--frames", "4", "--size", str(SIZE), "--compute_dtype",
                         "float32", "--device", "cpu", "--out", out], log=lambda s: None)
    art = _daemon_scores(DAEMON_ARGS + ["--artifact", out, "--warmup", "3,32,32"], clips)
    np.testing.assert_allclose(art, want, **SOLO_TOL)


def test_serve_daemon_refuses_what_is_not_ported(bundle):
    """What the JAX daemon refuses too: a data mesh over exported programs,
    and a quant mode beside an artifact."""
    with pytest.raises(ValueError, match="--use_mesh is not supported with --artifact"):
        serve_daemon.main(DAEMON_ARGS + ["--artifact", bundle, "--use_mesh", "true"],
                          started=[])
    with pytest.raises(ValueError, match="baked at export time"):
        serve_daemon.main(DAEMON_ARGS + ["--artifact", bundle, "--quantize", "w8a8"],
                          started=[])


def test_serve_daemon_use_mesh(bundle):
    """``--use_mesh true`` on the one CPU scores unsharded: each clip as the
    live scorer scores it alone."""
    clips = _clips((3, 4), seed=4)
    solo = VisualScorer.from_bundle(bundle, hidden_dim=HIDDEN, buckets=(4,), **F32)
    want = [solo.score(c[None])[0] for c in clips]
    got = _daemon_scores(DAEMON_ARGS + ["--ckpt_path", bundle, "--hidden_dim", str(HIDDEN),
                                        "--buckets", "4", "--warmup", "3,32,32", "--use_mesh",
                                        "true"], clips)
    np.testing.assert_allclose(got, want, **SOLO_TOL)


def test_jax_and_port_daemons_agree(model):
    """One request stream, the same weights, through both packages' daemons
    (batch bucket 4, T bucket 4: one JAX compile)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from multimodal_deepfake_detection_tpu.models import serve as jserve
    from multimodal_deepfake_detection_tpu.serving import MicroBatcher as JaxBatcher
    from multimodal_deepfake_detection_tpu.serving import ServingDaemon as JaxDaemon
    from multimodal_deepfake_detection_tpu.serving import VisualAdapter as JaxVisualAdapter

    params, state = xception_lstm_to_jax(model[0])
    jsc = jserve.VisualScorer(dict(params, arcface=arcface_to_jax(model[1])), state,
                              compute_dtype=jnp.float32, use_pallas=False, buckets=(4,))
    clips = _clips((2, 4, 3, 1, 4, 3), seed=4)
    scores = []
    for daemon in (
        JaxDaemon({"visual": JaxBatcher(JaxVisualAdapter(jsc), max_batch=4, max_wait_ms=50,
                                        batch_buckets=(4,))}, port=0),
        ServingDaemon({"visual": MicroBatcher(VisualAdapter(
            VisualScorer(*model, buckets=(4,), **F32)), max_batch=4, max_wait_ms=50,
            batch_buckets=(4,))}, port=0),
    ):
        with daemon as d:
            res = _concurrently(lambda i: _post(d.url + "/v1/score/visual", {"frames": clips[i]}),
                                len(clips))
        assert all(code == 200 for code, _ in res), res
        scores.append([obj["score"] for _, obj in res])
    np.testing.assert_allclose(scores[1], scores[0], rtol=0, atol=1e-4)
