"""The optimizer, the step machinery, EMA and the schedules against optax / JAX.

Fixed gradients, no model: a toy tree ``{backbone, head}`` whose loss is
``sum(p * G_k)``, so step k's gradient of p is exactly ``G_k``; the port's
``make_optimizer`` under its ``make_train_step`` and the JAX
``make_optimizer`` (optax) under JAX's ``make_train_step`` take the same
steps. Cases: Adam with L2 weight decay and a clip that binds, and one that
does not; AdamW; ``accum_steps=4`` (MultiSteps' average); the backbone frozen
(zero gradients that still decay); ``set_learning_rate`` between steps; the
equal-weight and the exponential EMA, with accumulation so that it folds in
only on real steps; a one-cycle schedule as the learning rate. Bar: every
parameter and EMA leaf rtol 1e-5 / atol 1e-7 after 8 steps (fp32; optax and
torch order Adam's divisions differently).

Schedules: ``onecycle_schedule`` at total_steps in {1, 2, 3, 10, 100}
against the JAX one (optax's ``cosine_onecycle_schedule`` with its guard) at
every step to total + 2, rtol 1e-6 / atol 1e-9 (JAX evaluates the cosine
in float32, whose ulp at the 3e-3 peak is 2.3e-10); ``PlateauScheduler`` LR sequences equal.
And the train-state snapshot: ``save_state`` then ``load_state`` gives back
the same parameters, moments, counts and EMA, and the next step matches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_deepfake_detection_tpu.train import TrainState as JState
from multimodal_deepfake_detection_tpu.train import ema_init as j_ema_init
from multimodal_deepfake_detection_tpu.train import make_optimizer as j_make_optimizer
from multimodal_deepfake_detection_tpu.train import set_learning_rate as j_set_lr
from multimodal_deepfake_detection_tpu.train.schedules import PlateauScheduler as JPlateau
from multimodal_deepfake_detection_tpu.train.schedules import onecycle_schedule as j_onecycle
from multimodal_deepfake_detection_tpu.train.steps import make_train_step as j_make_train_step
from multimodal_deepfake_detection_tpu_torch.core.checkpoint import load_state, save_state
from multimodal_deepfake_detection_tpu_torch.train import (
    PlateauScheduler,
    TrainState,
    ema_init,
    get_learning_rate,
    make_optimizer,
    onecycle_schedule,
    set_learning_rate,
)
from multimodal_deepfake_detection_tpu_torch.train.steps import make_train_step

TOL = dict(rtol=1e-5, atol=1e-7)
SHAPES = {"backbone": {"w": (3, 4), "b": (4,)}, "head": {"w": (4, 2)}}
STEPS = 8


class Toy(torch.nn.Module):
    def __init__(self, init):
        super().__init__()
        for k, leaves in init.items():
            sub = torch.nn.Module()
            for n, a in leaves.items():
                setattr(sub, n, torch.nn.Parameter(torch.from_numpy(a.copy())))
            setattr(self, k, sub)


def _init():
    rng = np.random.default_rng(0)
    return {k: {n: rng.normal(0, 1, s).astype(np.float32) for n, s in v.items()}
            for k, v in SHAPES.items()}


def _grads(scale):
    rng = np.random.default_rng(1)
    return [{k: {n: (rng.normal(0, scale, s)).astype(np.float32) for n, s in v.items()}
             for k, v in SHAPES.items()} for _ in range(STEPS)]


CASES = {  # name: (optimizer kwargs, gradient scale, step kwargs, frozen, lr changes)
    "adam_wd_clip_binds": (dict(name="adam", learning_rate=1e-2, weight_decay=1e-2,
                                grad_clip=0.5), 3.0, {}, (), {}),
    "adam_wd_clip_free": (dict(name="adam", learning_rate=1e-2, weight_decay=1e-2,
                               grad_clip=1e3), 3.0, {}, (), {}),
    "adamw": (dict(name="adamw", learning_rate=1e-2, weight_decay=5e-2), 1.0, {}, (), {}),
    "accum_4": (dict(name="adam", learning_rate=1e-2, weight_decay=1e-2, grad_clip=1.0,
                     accum_steps=4), 1.0, {}, (), {}),
    "frozen_backbone_decays": (dict(name="adam", learning_rate=1e-2, weight_decay=1e-1), 1.0,
                               {}, ("backbone",), {}),
    "set_learning_rate": (dict(name="adam", learning_rate=1e-2, weight_decay=1e-2), 1.0, {},
                          (), {3: 3e-3, 6: 1e-1}),
    "ema_equal_weight": (dict(name="adam", learning_rate=1e-2, accum_steps=2), 1.0,
                         dict(use_ema=True), (), {}),
    "ema_decay": (dict(name="adam", learning_rate=1e-2), 1.0,
                  dict(use_ema=True, ema_decay=0.9), (), {}),
    "onecycle": (dict(name="adam", learning_rate=("onecycle", 1e-2, 6)), 1.0, {}, (), {}),
}


def _lr(spec, module):
    if isinstance(spec, tuple):
        return (j_onecycle if module == "jax" else onecycle_schedule)(spec[1], spec[2])
    return spec


def _run_port(init, grads, okw, skw, frozen, lr_changes):
    model = Toy(init)
    okw = dict(okw, learning_rate=_lr(okw["learning_rate"], "port"))
    state = TrainState(0, model, make_optimizer(model.parameters(), **okw),
                       ema_init(model) if skw.get("use_ema") else None)

    def loss_forward(m, rng_seed, g):
        loss = sum((p * torch.from_numpy(g[k][n])).sum()
                   for k in SHAPES for n, p in getattr(m, k).named_parameters())
        return loss, ([], torch.zeros(1))

    step = make_train_step(loss_forward, **skw)
    for i, g in enumerate(grads):
        if i in lr_changes:
            set_learning_rate(state.optimizer, lr_changes[i])
            assert get_learning_rate(state.optimizer) == lr_changes[i]
        step(state, g, i, frozen)
    params = {k: {n: p.detach().numpy() for n, p in getattr(model, k).named_parameters()}
              for k in SHAPES}
    ema = None if state.ema is None else {
        k: {n: state.ema.params[f"{k}.{n}"].numpy() for n in SHAPES[k]} for k in SHAPES}
    return params, ema


def _run_jax(init, grads, okw, skw, frozen, lr_changes):
    okw = dict(okw, learning_rate=_lr(okw["learning_rate"], "jax"))
    name = okw.pop("name")
    tx = j_make_optimizer(name, **okw)
    params = jax.tree_util.tree_map(jnp.asarray, init)

    def loss_forward(p, bn, rng, g):
        loss = sum(jnp.sum(p[k][n] * g[k][n]) for k in SHAPES for n in SHAPES[k])
        return loss, (bn, jnp.zeros(1))

    state = JState(jnp.zeros((), jnp.int32), params, {}, tx.init(params),
                   j_ema_init(params) if skw.get("use_ema") else None)
    step = j_make_train_step(loss_forward, tx, **skw)
    for i, g in enumerate(grads):
        if i in lr_changes:
            state = state._replace(opt_state=j_set_lr(state.opt_state, lr_changes[i]))
        state, _, _ = step(state, jax.tree_util.tree_map(jnp.asarray, g), i, frozen)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return np_tree(state.params), None if state.ema is None else np_tree(state.ema.params)


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_step_matches_optax(case):
    okw, gscale, skw, frozen, lr_changes = CASES[case]
    init, grads = _init(), _grads(gscale)
    t_params, t_ema = _run_port(init, grads, okw, skw, frozen, lr_changes)
    j_params, j_ema = _run_jax(init, grads, dict(okw), skw, frozen, lr_changes)
    for k in SHAPES:
        for n in SHAPES[k]:
            np.testing.assert_allclose(t_params[k][n], j_params[k][n], err_msg=f"{k}.{n}", **TOL)
            assert not np.array_equal(t_params[k][n], init[k][n]), f"{k}.{n} did not move"
            if t_ema is not None:
                np.testing.assert_allclose(t_ema[k][n], j_ema[k][n], err_msg=f"ema {k}.{n}",
                                           **TOL)


@pytest.mark.parametrize("total", [1, 2, 3, 10, 100])
def test_onecycle_matches_optax(total):
    js, ts = j_onecycle(3e-3, total), onecycle_schedule(3e-3, total)
    got = [ts(i) for i in range(max(total, 4) + 3)]
    want = [float(js(i)) for i in range(max(total, 4) + 3)]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_plateau_matches_jax(mode):
    rng = np.random.default_rng(3)
    metrics = list(np.cumsum(rng.normal(0, 1, 40)))
    j = JPlateau(1e-3, mode=mode, factor=0.5, patience=2, min_lr=1e-5)
    t = PlateauScheduler(1e-3, mode=mode, factor=0.5, patience=2, min_lr=1e-5)
    assert [t.step(m) for m in metrics] == [j.step(m) for m in metrics]


def test_train_state_snapshot_round_trip(tmp_path):
    init, grads = _init(), _grads(1.0)
    okw, _, skw, _, _ = CASES["ema_equal_weight"]

    def make():
        model = Toy(init)
        return TrainState(0, model, make_optimizer(model.parameters(), **okw), ema_init(model))

    def loss_forward(m, rng_seed, g):
        return sum((p * torch.from_numpy(g[k][n])).sum()
                   for k in SHAPES for n, p in getattr(m, k).named_parameters()), ([], None)

    step = make_train_step(lambda m, s, g: (lambda r: (r[0], ([], torch.zeros(1))))(
        loss_forward(m, s, g)), **skw)
    a = make()
    for i in range(3):
        step(a, grads[i], i)
    save_state(str(tmp_path / "s.pt"), a)
    b = load_state(str(tmp_path / "s.pt"), like=make())
    assert b.step == 3 and b.optimizer.mini_step == a.optimizer.mini_step == 1
    assert b.ema.count == a.ema.count
    for s in (a, b):
        step(s, grads[3], 3)
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(a.ema.params[n], b.ema.params[n]), n


def test_eval_step_with_ema_params_matches_jax():
    """``make_eval_step(use_ema_params=True)`` evaluates with the averaged
    parameters and leaves the live ones in place, as JAX's does."""
    from multimodal_deepfake_detection_tpu.train.steps import make_eval_step as j_make_eval_step
    from multimodal_deepfake_detection_tpu_torch.train.steps import make_eval_step

    init, grads = _init(), _grads(1.0)
    okw, _, skw, _, _ = CASES["ema_decay"]
    model = Toy(init)
    state = TrainState(0, model, make_optimizer(model.parameters(), **okw), ema_init(model))

    def loss_forward(m, rng_seed, g):
        loss = sum((p * torch.from_numpy(g[k][n])).sum()
                   for k in SHAPES for n, p in getattr(m, k).named_parameters())
        return loss, ([], torch.zeros(1))

    step = make_train_step(loss_forward, **skw)
    for i, g in enumerate(grads):
        step(state, g, i)
    x = np.linspace(-1, 1, 4 * 3, dtype=np.float32).reshape(4, 3)

    def t_eval(m, batch):
        h = torch.from_numpy(batch) @ m.backbone.w + m.backbone.b
        return (h @ m.head.w).square().mean(), h.sum(1)

    live = {n: p.detach().clone() for n, p in model.named_parameters()}
    t_loss, t_out = make_eval_step(t_eval, use_ema_params=True)(state, x)
    for n, p in model.named_parameters():
        assert torch.equal(p, live[n]), n

    _, j_ema = _run_jax(init, grads, dict(okw), skw, (), {})

    def j_eval(p, bn, batch):
        h = batch @ p["backbone"]["w"] + p["backbone"]["b"]
        return jnp.mean((h @ p["head"]["w"]) ** 2), h.sum(1)

    params = jax.tree_util.tree_map(jnp.asarray, init)
    jstate = JState(jnp.zeros((), jnp.int32), params, {}, None,
                    j_ema_init(jax.tree_util.tree_map(jnp.asarray, j_ema)))
    j_loss, j_out = j_make_eval_step(j_eval, use_ema_params=True)(jstate, jnp.asarray(x))
    np.testing.assert_allclose(t_loss.item(), float(j_loss), **TOL)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
