"""Seeded weights in the port's bundle layout, made on the device.

A bundle is the ``.npz`` that ``train_visual`` / ``train_audio`` write
(``model``, ``state`` and, for the visual model, ``arcface``; JAX layouts:
conv HWIO, depthwise ``(3, 3, 1, C)``, linear ``(in, out)``, LSTM ``w_ih (D,
4H)``). The leaves come from the configuration's block table; their values
from two draws on the device, a normal one and a uniform one, each shaped
per leaf by a scale and shift repeated over its elements, then copied to
the host in one transfer. The bundle lives in memory (``io.BytesIO``): the
port's ``from_bundle`` reads it as it reads a file, and nothing is written
to disk.

Distributions (random weights at the published widths, chosen so that the
scores depend on the input; with the init of training the deep features
of every input coincide and every clip gets one score):

- convs: He-normal on the fan-in, ``std = sqrt(2 / (kh * kw * in))``
  (depthwise: ``in = 1``);
- BN: scale U(0.8, 1.2), bias 0.05 N; the running statistics are those a
  trained network holds, the statistics of its own inputs: each BN's are
  measured on a few of the benchmark's own images (``calibration``, drawn
  from the seed) in one fp32 forward of the reference, in order, and then
  jittered (mean + 0.1 std N, var U(0.7, 1.3)), so the fold is exercised
  and the activations keep their scale through the depth;
- LSTM: U(+-1/sqrt(H)), as in training;
- the MLP head: He-uniform, U(+-sqrt(6 / in)); ``fc_out`` drawn U(+-sqrt(3 /
  in)), then scaled and shifted so that its logits over calibration clips
  spread (:func:`set_head`);
- ArcFace: drawn Xavier-uniform, then placed so that its logits over
  calibration clips spread (:func:`set_head`).
"""
from __future__ import annotations

import io
import math
from typing import Iterator, List, Tuple

import numpy as np
import torch

# (key, JAX shape, distribution, a, b): normal -> a + b * N(0, 1), uniform -> U(a, b)
Leaf = Tuple[str, tuple, str, float, float]


def block_units(row) -> List[Tuple[int, int]]:
    """One block's per-unit (in, out) channels (``grow_first`` as Xception)."""
    cin, cout, reps, _, _, grow_first = row
    if grow_first:
        return [(cin, cout)] + [(cout, cout)] * (reps - 1)
    return [(cin, cin)] * (reps - 1) + [(cin, cout)]


def _conv(key: str, kh: int, cin: int, cout: int) -> Leaf:
    return (key, (kh, kh, cin, cout), "normal", 0.0, math.sqrt(2.0 / (kh * kh * cin)))


def _bn(path: str, c: int) -> Iterator[Leaf]:
    yield f"model/{path}/scale", (c,), "uniform", 0.8, 1.2
    yield f"model/{path}/bias", (c,), "normal", 0.0, 0.05
    yield f"state/{path}/mean", (c,), "normal", 0.0, 0.1  # jitter, in stds
    yield f"state/{path}/var", (c,), "uniform", 0.7, 1.3  # jitter, a factor


def _sep(prefix: str, cin: int, cout: int) -> Iterator[Leaf]:
    yield (f"model/{prefix}/depthwise/w", (3, 3, 1, cin), "normal", 0.0, math.sqrt(2.0 / 9))
    yield _conv(f"model/{prefix}/pointwise/w", 1, cin, cout)


def _linear(prefix: str, cin: int, cout: int, bound: float) -> Iterator[Leaf]:
    yield f"model/{prefix}/w", (cin, cout), "uniform", -bound, bound
    yield f"model/{prefix}/b", (cout,), "uniform", -bound, bound


def leaves(cfg: dict) -> List[Leaf]:
    """Every leaf of the configuration's bundle, in a fixed order."""
    out: List[Leaf] = []
    b = "backbone"
    out.append(_conv(f"model/{b}/conv1/w", 3, 3, 32))
    out += _bn(f"{b}/bn1", 32)
    out.append(_conv(f"model/{b}/conv2/w", 3, 32, 64))
    out += _bn(f"{b}/bn2", 64)
    for k, row in enumerate(cfg["xception_blocks"]["rows"]):
        cin, cout, _, stride, _, _ = row
        for i, (ci, co) in enumerate(block_units(row)):
            out += _sep(f"{b}/blocks/{k}/units/{i}/sep", ci, co)
            out += _bn(f"{b}/blocks/{k}/units/{i}/bn", co)
        if cout != cin or stride != 1:
            out.append(_conv(f"model/{b}/blocks/{k}/skip/conv/w", 1, cin, cout))
            out += _bn(f"{b}/blocks/{k}/skip/bn", cout)
    for n, (ci, co) in zip((3, 4), cfg["xception_blocks"]["exit"]):
        out += _sep(f"{b}/conv{n}", ci, co)
        out += _bn(f"{b}/bn{n}", co)
    D, H, M = cfg["feature_dim"], cfg["hidden_dim"], cfg["mlp_width"]
    bound = 1.0 / math.sqrt(H)
    for name, shape in (("w_ih", (D, 4 * H)), ("w_hh", (H, 4 * H)), ("b_ih", (4 * H,)),
                        ("b_hh", (4 * H,))):
        out.append((f"model/lstm/{name}", shape, "uniform", -bound, bound))
    for i, cin in enumerate((H, M, M, M)):
        out += _linear(f"fc_layers/{i}", cin, M, math.sqrt(6.0 / cin))
    out += _linear("fc_out", M, 1, math.sqrt(3.0 / M))
    if "arcface_s" in cfg:
        limit = math.sqrt(6.0 / (cfg["num_classes"] + H))
        out.append(("arcface/w", (cfg["num_classes"], H), "uniform", -limit, limit))
    return out


def _shaped(draw: torch.Tensor, sel: List[Leaf]) -> torch.Tensor:
    """One draw's elements, each leaf's share scaled and shifted in one op."""
    sizes = torch.tensor([int(np.prod(s)) for _, s, _, _, _ in sel], device=draw.device)
    a = torch.tensor([l[3] for l in sel], dtype=torch.float32, device=draw.device)
    b = torch.tensor([l[4] for l in sel], dtype=torch.float32, device=draw.device)
    a, b = (torch.repeat_interleave(t, sizes) for t in (a, b))
    if sel[0][2] == "normal":
        return a + b * draw
    return a + (b - a) * draw


def make_tensors(cfg: dict, seed: int, device) -> dict:
    """``{bundle key: fp32 tensor on device}`` drawn from ``seed``; the BN
    running statistics hold their jitter until :func:`set_bn_statistics`."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    all_leaves = leaves(cfg)
    out = {}
    for kind, draw in (("normal", torch.randn), ("uniform", torch.rand)):
        sel = [l for l in all_leaves if l[2] == kind]
        n = sum(int(np.prod(s)) for _, s, _, _, _ in sel)
        flat = _shaped(draw(n, generator=g, device=device, dtype=torch.float32), sel)
        for key, part in zip((l[0] for l in sel),
                             flat.split([int(np.prod(l[1])) for l in sel])):
            out[key] = part
    return {key: out[key].reshape(shape) for key, shape, _, _, _ in all_leaves}


def set_bn_statistics(cfg: dict, tensors: dict, calibration: torch.Tensor) -> None:
    """Each BN's running statistics from its input over the ``calibration``
    images (NHWC fp32), in one forward in order: mean + jitter * std and
    var * jitter, the jitter as :func:`make_tensors` drew it."""
    from bench_port.reference import ieee_fp32, xception

    def observe(path, x):
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        m, v = f"state/{path}/mean", f"state/{path}/var"
        tensors[m] = mean + tensors[m] * var.sqrt()
        tensors[v] = var * tensors[v]

    with ieee_fp32(), torch.no_grad():
        xception.features(tensors, cfg, calibration, observe=observe)


LOGIT_STD = 1.5  # the head's logit spread over the calibration clips


def set_head(cfg: dict, tensors: dict, calibration: torch.Tensor, clips: int) -> None:
    """The head's output, placed on the calibration clips' embeddings (the
    LSTM's last steps over ``calibration``, which holds the clips' steps in
    order) so that their logits have mean 0 and standard deviation
    :data:`LOGIT_STD`: the scores of a batch then spread, as a trained
    head's do, on every seed.

    MLP head: ``fc_out`` scaled and shifted. ArcFace (its scale ``s`` is the
    configuration's): the two class centres set to ``m -+ beta r``, ``m`` the
    normalised embeddings' mean direction and ``r`` a drawn direction
    orthogonal to it, ``beta`` solved for the spread (the logit is ``s * 2
    beta / sqrt(1 + beta^2) * (e . r)``, centred since ``r`` is orthogonal to
    the mean)."""
    from bench_port.reference import heads, ieee_fp32, xception

    with ieee_fp32(), torch.no_grad():
        feats = xception.features(tensors, cfg, calibration).reshape(clips, -1, cfg["feature_dim"])
        lengths = torch.full((clips,), feats.shape[1], device=feats.device)
        h = heads.lstm_last(tensors, feats, lengths)
        if "arcface_s" in cfg:
            e = h / h.norm(dim=-1, keepdim=True)
            m = e.mean(0)
            m = m / m.norm()
            r = tensors["arcface/w"][1] - tensors["arcface/w"][0]  # a drawn direction
            r = r - (r @ m) * m
            r = r / r.norm()
            k = min(LOGIT_STD / (cfg["arcface_s"] * float((e @ r).std())), 1.9)
            beta = k / (4 - k * k) ** 0.5
            tensors["arcface/w"] = torch.stack([m - beta * r, m + beta * r])  # (real, fake)
            return
        for i in range(4):
            h = torch.relu(h @ tensors[f"model/fc_layers/{i}/w"] + tensors[f"model/fc_layers/{i}/b"])
        logit = (h @ tensors["model/fc_out/w"])[:, 0]
        k = LOGIT_STD / logit.std()
        tensors["model/fc_out/w"] = tensors["model/fc_out/w"] * k
        tensors["model/fc_out/b"] = -(logit * k).mean().reshape(1)


def make_bundle(cfg: dict, seed: int, calibration: torch.Tensor, clips: int = 1) -> io.BytesIO:
    """The seeded bundle as ``.npz`` bytes in memory, positioned at 0, made on
    ``calibration``'s device: :func:`make_tensors`, :func:`set_bn_statistics`,
    one copy to the host."""
    tensors = make_tensors(cfg, seed, calibration.device)
    set_bn_statistics(cfg, tensors, calibration)
    set_head(cfg, tensors, calibration, clips)
    keys = list(tensors)
    flat = torch.cat([tensors[k].reshape(-1) for k in keys]).cpu().numpy()
    arrays, at = {}, 0
    for k in keys:
        size = tensors[k].numel()
        arrays[k] = flat[at: at + size].reshape(tuple(tensors[k].shape))
        at += size
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    buf.seek(0)
    return buf


def parameter_count(cfg: dict) -> int:
    """Trained parameters (BN running statistics excluded) of the bundle."""
    return sum(int(np.prod(s)) for k, s, _, _, _ in leaves(cfg) if not k.startswith("state/"))
