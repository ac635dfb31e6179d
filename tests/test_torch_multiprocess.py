"""The port's data-parallel train step and multi-device dry run over gloo
processes on the CPU.

One 4-rank cluster (``tests/torch_mp_worker.py``, spawned once for the
module through ``parallel/dryrun.py::spawn_ranks``) serves every case. Its
ranks 0 and 1 run the compact twin of ``tests/mp_worker.py``'s model through
``train.steps.make_train_step(data_group=...)``, each rank on its block of
the global batch, and is held to the same step in one process and to JAX's
``build_and_step(None)``, at ``tests/test_multichip.py``'s bars:

* train-mode BN: the loss within rel 1e-3, the BN running statistics within
  rel 1e-4;
* eval-mode BN: the loss within rel 1e-5, the gradients within rtol 1e-3
  (its negligible-leaf rule), the updated parameters within rel 1e-6.

The padded cases put the batch's two ``lengths == 0`` rows on rank 1 only;
their control, per-rank BN and per-rank loss means with averaged gradients
(what ``DistributedDataParallel`` around the step would compute), must miss
those bars. Then all 4 ranks run ``parallel/dryrun.py``: a DP x TP step
(2 x 2) held to one process, the DCP save and restore of TP-sharded DTensors with a bit-equal
continued step, ``hybrid_mesh(dcn_data=2)`` and the sharded AV scorer.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mp_worker as W  # noqa: E402
from test_multichip import _assert_grads_match, _tree_rel_norm_diff  # noqa: E402

from multimodal_deepfake_detection_tpu_torch.parallel.distributed import free_port  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.parallel.dryrun import (  # noqa: E402
    check_ranks,
    spawn_ranks,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4


def _jax_init():
    """``build_and_step``'s initial params and BN state, as numpy trees."""
    import jax

    from multimodal_deepfake_detection_tpu.ops.conv import (
        batch_norm_init,
        conv2d_init,
        linear_init,
    )
    from multimodal_deepfake_detection_tpu.ops.lstm import lstm_init

    r1, r2, r3 = jax.random.split(jax.random.PRNGKey(0), 3)
    bn_p, bn_s = batch_norm_init(8)
    params = {"backbone": {"conv": conv2d_init(r1, 3, 8, 3), "bn": bn_p},
              "lstm": lstm_init(r2, 8, 8), "head": linear_init(r3, 8, 1)}
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return host(params), host({"backbone": {"bn": bn_s}})


@functools.lru_cache(maxsize=None)
def _init_state() -> dict:
    """The compact model's initial state dict: JAX's init carried across."""
    return W.model_from_jax(*_jax_init()).state_dict()


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mp"))


@pytest.fixture(scope="module")
def cluster4(out_dir):
    """The 4 ranks' dry-run results; the DP cases' and the loader's files in
    ``out_dir``. The JAX init runs while the ranks start."""
    port = free_port()
    return spawn_ranks(WORLD, lambda r: [
        sys.executable, os.path.join(REPO, "tests", "torch_mp_worker.py"), str(r), str(WORLD),
        str(port), out_dir, os.path.join(out_dir, "dcp")],
        feed=lambda: W.state_bytes(_init_state()), timeout=600)


@pytest.fixture(scope="module")
def cluster(cluster4, out_dir):
    """Each DP case's per-rank results of ranks 0 and 1 (and its control)."""
    def load(name, rank):
        return dict(np.load(os.path.join(out_dir, f"{name}_rank{rank}.npz")))

    return {f"{tag}{case}": [load(f"{tag}{case}", r) for r in range(W.DP)]
            for case in W.CASES for tag in ("", "ddp_")}


@pytest.fixture(scope="module")
def single():
    """Each case's step in one process on the whole batch."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for case in W.CASES:
            model = W.Compact()
            model.load_state_dict(_init_state())
            out[case] = W.run_case(case, model)
        return out
    finally:
        torch.set_num_threads(before)


def _tree(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _train_bars_hold(got, ref) -> bool:
    return (_rel(got["loss"], ref["loss"]) < 1e-3
            and _tree_rel_norm_diff(_tree(ref, "bn/"), _tree(got, "bn/")) < 1e-4)


def _eval_bars_hold(got, ref) -> bool:
    if _rel(got["loss"], ref["loss"]) >= 1e-5:
        return False
    if _tree_rel_norm_diff(_tree(ref, "param/"), _tree(got, "param/")) >= 1e-6:
        return False
    try:
        _assert_grads_match(_tree(ref, "grad/"), _tree(got, "grad/"), 1e-3, "dp")
    except AssertionError:
        return False
    return True


def test_ranks_agree(cluster):
    """Every rank ends the step with the same loss, probabilities, params,
    gradients and BN statistics."""
    for case in W.CASES:
        a, b = cluster[case]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{case}: {k}")


@pytest.mark.parametrize("case", ["train", "padded_train"])
def test_train_bn_step_matches_single_process(cluster, single, case):
    got, ref = cluster[case][0], single[case]
    assert _rel(got["loss"], ref["loss"]) < 1e-3, (got["loss"], ref["loss"])
    assert _tree_rel_norm_diff(_tree(ref, "bn/"), _tree(got, "bn/")) < 1e-4
    np.testing.assert_allclose(got["probs"], ref["probs"], rtol=1e-4)


@pytest.mark.parametrize("case", ["eval", "padded_eval"])
def test_eval_bn_step_matches_single_process(cluster, single, case):
    got, ref = cluster[case][0], single[case]
    assert _rel(got["loss"], ref["loss"]) < 1e-5, (got["loss"], ref["loss"])
    _assert_grads_match(_tree(ref, "grad/"), _tree(got, "grad/"), 1e-3, case)
    assert _tree_rel_norm_diff(_tree(ref, "param/"), _tree(got, "param/")) < 1e-6


@pytest.mark.parametrize("case,bars", [("padded_train", _train_bars_hold),
                                       ("padded_eval", _eval_bars_hold)])
def test_per_rank_reductions_miss_the_bars(cluster, single, case, bars):
    """The control: with the padded rows on one rank, per-rank BN and loss
    means (gradients averaged) are not the global step; the same bars hold
    for the port's step and fail for the control."""
    assert bars(cluster[case][0], single[case])
    assert not bars(cluster["ddp_" + case][0], single[case])


def test_single_process_and_dp_steps_match_jax(cluster, single):
    """The port's step, in one process and over two ranks, against JAX's
    ``build_and_step(None)`` on the same global batch and initial weights:
    the loss, the probabilities' sum, every updated parameter's norm and the
    BN running statistics' norms."""
    from mp_worker import build_and_step

    ref = build_and_step(None)
    m = W.Compact()
    keystr = {id(t): "".join(f"['{k}']" for k in path) for _, path, t, _ in W.compact_leaves(m)}
    want = {**{f"param/{n}": ref["param_norms"][keystr[id(t)]] for n, t in m.named_parameters()},
            **{f"bn/{n}": ref["bn_norms"][keystr[id(t)]] for n, t in m.named_buffers()}}
    for got in (single["train"], cluster["train"][0]):
        assert _rel(got["loss"], ref["loss"]) < 1e-3, (got["loss"], ref["loss"])
        assert np.isclose(got["probs"].sum(), ref["probs_sum"], rtol=1e-4)
        for key, norm in want.items():
            assert np.isclose(np.linalg.norm(got[key]), norm, rtol=1e-4), key


def test_rank_rows_load_only_their_rows(cluster4, out_dir):
    """Each of the 4 ranks' data-parallel loader (``RankRows``) gives, batch
    for batch, its rows of the one-process loader's batch (bit-equal, the
    time axis padded to the global bucket although its own items may be
    shorter) and the whole batch's labels and lengths, and reads only the
    items of its rows: every item is read once over the ranks."""
    from multimodal_deepfake_detection_tpu_torch.data.loader import DataLoader
    from multimodal_deepfake_detection_tpu_torch.parallel.mesh import data_sharding

    full = list(DataLoader(W.CountingSeqs(), **W.LOADER))
    assert len(full) == 2
    loaded = []
    for r, rows in enumerate(data_sharding(WORLD, W.LOADER["batch_size"])):
        got = np.load(os.path.join(out_dir, f"loader_rank{r}.npz"))
        for i, (x, labels, lengths) in enumerate(full):
            for name, a, want in (("x", got[f"x{i}"], x[rows]), ("labels", got[f"labels{i}"], labels),
                                  ("lengths", got[f"lengths{i}"], lengths)):
                assert a.dtype == want.dtype, (r, i, name)
                np.testing.assert_array_equal(a, want, err_msg=f"rank {r} batch {i}: {name}")
        loaded.extend(got["loaded"].tolist())
    assert sorted(loaded) == list(range(13))


def test_dryrun_multichip_4_cpu(cluster4):
    """``dryrun_multichip(4, device="cpu")``'s ranks, run by the module's
    cluster: a (2 x 2) DP x TP step held to the one-process step (the
    model-sharded gradients doubled must miss the bar), the DCP round trip
    of TP-sharded DTensors continued bit-equal, the (dcn, data) hybrid mesh
    and the sharded AV scorer."""
    res = check_ranks(cluster4)
    assert res["mesh"] == [2, 2] and np.isfinite(res["loss"])
    text = "\n".join(res["lines"])
    for what in ("mesh=(2x2) devices=4", "single-process OK", "checkpoint OK",
                 "(dcn, data) = (2, 2)", "AV eval OK: AVScorer sharded over 4 devices"):
        assert what in text, text
    vs = res["vs_single"]  # the DP x TP step against one process, and the planted control
    assert vs["loss"] < 1e-5 and vs["param"] < 1e-6 and vs["grad"] < 1e-3 and vs["bn"] < 1e-4
    assert vs["planted_grad"] >= 1e-3
    assert res["av_max_abs_err"] <= 1e-6


def test_dryrun_cuda_without_gpus_raises(monkeypatch):
    """No fallback: asking for more GPUs than are visible raises."""
    from multimodal_deepfake_detection_tpu_torch.parallel.dryrun import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        dryrun_multichip(2, device="cuda")
