"""One rank of a gloo cluster running the port's data-parallel train step,
then the multi-device dry run.

Spawned by ``tests/test_torch_multiprocess.py`` (4 ranks), and imported by
it for the same model and step run in one process. Ranks 0 and 1 run the
data-parallel cases in a group of their own. The model is the port's twin
of ``tests/mp_worker.py::build_and_step``'s compact one (conv -> live BN ->
LSTM -> linear head, BCE on the sigmoid, Adam 1e-3 with clip 1.0, the EMA),
built from the port's ops; its initial weights are the JAX init's, carried
across by ``utils/jax_weights.py``. Each rank computes its contiguous block
of the global batch's rows and saves what the step produced. Every rank
first reads an epoch of a data-parallel loader (``RankRows``, which loads
the rank's rows only), saving its batches and the items it loaded, and
runs its rank of ``parallel/dryrun.py`` in the same process group; the
initial weights (a ``torch.save`` state dict on standard input) are read
only then, so the spawner can make them meanwhile. The results are printed
as ``RESULT <json>``.

Not a test module (pytest collects test_*.py only).
"""
import os
import sys

import numpy as np
import torch
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multimodal_deepfake_detection_tpu_torch.models.losses import bce_loss  # noqa: E402
from multimodal_deepfake_detection_tpu_torch.ops.conv import (  # noqa: E402
    BatchNorm,
    Linear,
    conv2d,
    dense,
    global_avg_pool,
)
from multimodal_deepfake_detection_tpu_torch.ops.lstm import (  # noqa: E402
    LSTM,
    lstm_apply,
    select_last_step,
)
from multimodal_deepfake_detection_tpu_torch.utils import jax_weights  # noqa: E402

B, T, S = 8, 3, 16
DP = 2  # the data-parallel cases' ranks
CASES = ("train", "eval", "padded_train", "padded_eval")


class Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Parameter(torch.zeros(8, 3, 3, 3))
        self.bn = BatchNorm(8)


class Compact(nn.Module):
    """``{backbone: {conv, bn}, lstm, head}``, the JAX tree's names."""

    def __init__(self):
        super().__init__()
        self.backbone = Backbone()
        self.lstm = LSTM(8, 8)
        self.head = Linear(8, 1)


def compact_leaves(m: Compact):
    yield "params", ("backbone", "conv", "w"), m.backbone.conv, "conv"
    yield from jax_weights._bn_leaves(("backbone", "bn"), m.backbone.bn)
    yield from jax_weights._lstm_leaves(("lstm",), m.lstm)
    yield from jax_weights._linear_leaves(("head",), m.head)


def model_from_jax(params, state) -> Compact:
    m = Compact()
    jax_weights._import(compact_leaves(m), params, state)
    return m


def batch(case: str):
    """The global batch (the JAX worker's, seed 7); the padded cases zero
    the last two rows and give them ``lengths == 0``: with two ranks both
    fall on rank 1."""
    rng = np.random.default_rng(7)
    video = rng.random((B, T, S, S, 3), np.float32)
    labels = (np.arange(B) % 2).astype(np.float32)
    lengths = np.full((B,), T, np.int64)
    if case.startswith("padded"):
        video[-2:], lengths[-2:] = 0.0, 0
    return video, labels, lengths


def forward(train_bn: bool):
    def loss_forward(model, rng_seed, batch):
        video, labels, lengths = batch
        n = video.shape[0]
        x = conv2d(video.reshape((n * T, S, S, 3)), model.backbone.conv, stride=2, padding=1)
        if train_bn:
            x, stats = model.backbone.bn.train_forward(x)
            bn_stats = [(model.backbone.bn, stats)]
        else:
            x, bn_stats = model.backbone.bn(x), []
        feats = global_avg_pool(torch.relu(x)).reshape(n, T, -1)
        hs, _ = lstm_apply(model.lstm, feats)
        probs = torch.sigmoid(dense(model.head, select_last_step(hs, lengths))[:, 0])
        loss = bce_loss(probs, labels, sample_weight=(lengths > 0).float())
        return loss, (bn_stats, probs)
    return loss_forward


def run_case(case: str, model: Compact, rows=slice(None), group=None, ddp_style=False) -> dict:
    """One train step of ``case`` on the ``rows`` of its batch; ``group``:
    the data-parallel group. ``ddp_style`` is the control: per-rank BN and
    per-rank loss means, the gradients averaged over the ranks."""
    import torch.distributed as dist

    from multimodal_deepfake_detection_tpu_torch.train import (
        TrainState,
        ema_init,
        make_optimizer,
    )
    from multimodal_deepfake_detection_tpu_torch.train.steps import make_train_step

    opt = make_optimizer(model.parameters(), "adam", 1e-3, grad_clip=1.0)
    state = TrainState(0, model, opt, ema_init(model))
    step_fwd = forward(case.endswith("train"))
    tensors = tuple(torch.from_numpy(a[rows]) for a in batch(case))
    if ddp_style:
        loss, (bn_stats, probs) = step_fwd(model, 0, tensors)
        opt.zero_grad()
        loss.backward()
        world = dist.get_world_size(group)
        for p in model.parameters():
            dist.all_reduce(p.grad, group=group)
            p.grad /= world
        for bn, (mean, var) in bn_stats:
            bn.update(mean, var)
        opt.step()
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group)
        loss /= world
    else:
        step = make_train_step(step_fwd, use_ema=True, data_group=group)
        state, loss, probs = step(state, tensors, 0)
    out = {"loss": loss.detach().double().numpy(), "probs": probs.detach().double().numpy()}
    for name, p in model.named_parameters():
        out[f"param/{name}"] = p.detach().double().numpy()
        out[f"grad/{name}"] = p.grad.double().numpy()
    for name, b in model.named_buffers():
        out[f"bn/{name}"] = b.double().numpy()
    return out


class CountingSeqs:
    """Items ``(x (t, 2, 3) float32, label)`` of lengths 1 to 6 from a seed;
    ``loaded`` records the indices read."""

    def __init__(self, n: int = 13):
        rng = np.random.default_rng(5)
        self.all_labels = [int(y) for y in rng.integers(0, 2, n)]
        self.data = [rng.random((int(t), 2, 3)).astype(np.float32) for t in rng.integers(1, 7, n)]
        self.loaded = []

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        self.loaded.append(i)
        return self.data[i], self.all_labels[i]


# 13 items in batches of 8: the last batch's 5 items leave rank 3 pad rows only
LOADER = dict(batch_size=8, shuffle=True, seed=3, buckets=(2, 4, 6))


def sharded_epoch(rank: int, world: int, out_dir: str) -> None:
    """An epoch of ``RankRows`` over :class:`CountingSeqs`, saved."""
    import torch.distributed as dist

    from multimodal_deepfake_detection_tpu_torch.data.loader import DataLoader
    from multimodal_deepfake_detection_tpu_torch.parallel.distributed import DataParallelRun

    ds = CountingSeqs()
    run = DataParallelRun(dist.group.WORLD, rank, world)
    out = {"loaded": np.asarray(ds.loaded)}
    for i, batch in enumerate(run.loader(DataLoader(ds, **LOADER))):
        out.update({f"{k}{i}": a for k, a in zip(("x", "labels", "lengths"), batch)})
    out["loaded"] = np.asarray(sorted(ds.loaded))
    np.savez(os.path.join(out_dir, f"loader_rank{rank}.npz"), **out)


def main():
    rank, world, port, out_dir, ckdir = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                                         *sys.argv[4:6])
    torch.set_num_threads(1)
    import io
    import json

    import torch.distributed as dist

    from multimodal_deepfake_detection_tpu_torch.parallel.distributed import initialize
    from multimodal_deepfake_detection_tpu_torch.parallel.dryrun import run_rank
    from multimodal_deepfake_detection_tpu_torch.parallel.mesh import data_sharding

    initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    group = dist.new_group(list(range(DP)))
    sharded_epoch(rank, world, out_dir)
    res = run_rank(rank, world, port, "cpu", ckdir)
    init = torch.load(io.BytesIO(sys.stdin.buffer.read()))
    if rank < DP:
        rows = data_sharding(DP, B)[rank]
        for case in CASES:
            for ddp_style in (False, True):
                model = Compact()
                model.load_state_dict(init)
                out = run_case(case, model, rows, group, ddp_style)
                tag = "ddp_" if ddp_style else ""
                np.savez(os.path.join(out_dir, f"{tag}{case}_rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print("RESULT " + json.dumps(res), flush=True)


def state_bytes(state: dict) -> bytes:
    """``state`` as the bytes :func:`main` reads from standard input."""
    import io

    buf = io.BytesIO()
    torch.save(state, buf)
    return buf.getvalue()


if __name__ == "__main__":
    main()
