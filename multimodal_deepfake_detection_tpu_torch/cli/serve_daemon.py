"""Online scoring daemon: HTTP and dynamic micro-batching over any engine.

Counterpart of ``multimodal_deepfake_detection_tpu/cli/serve_daemon.py``.
``cli/serve.py`` is the offline path; this is the online one: single-clip
requests are coalesced into bucket-shaped batches (``serving/batcher.py``)
and served over HTTP (``serving/daemon.py``), scored on the card.

    python -m multimodal_deepfake_detection_tpu_torch.cli.serve_daemon \\
        --engine visual --ckpt_path best.npz --port 8810 \\
        --max_batch 16 --max_wait_ms 5 --warmup 8,256,256

    curl -XPOST localhost:8810/v1/score/visual \\
        -H 'Content-Type: application/x-npz' --data-binary @clip.npz

Score a clip from Python:

    import io, urllib.request, numpy as np
    buf = io.BytesIO(); np.savez(buf, frames=frames_u8)
    req = urllib.request.Request(url + "/v1/score/visual", buf.getvalue(),
                                 {"Content-Type": "application/x-npz"})
    print(urllib.request.urlopen(req).read())

``--warmup T[,H,W]`` scores a zero clip of that shape once per batch bucket
at start-up, so live traffic never pays a first call's set-up (kernel
builds, cuDNN's algorithm search). Every flag of ``cli/serve.py``'s
``Config`` applies (``--device``, ``--quantize``, the kernel routes,
``--use_mesh``, whose data mesh is sized by ``--max_batch``);
``--artifact a_T8.ptprog,...`` serves from exported programs instead of a
checkpoint (``models/artifact.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np

from ..core.config import parse_config
from .serve import Config as EngineConfig
from .serve import build_engine, data_mesh


@dataclasses.dataclass
class Config(EngineConfig):
    host: str = "127.0.0.1"
    port: int = 8810
    max_batch: int = 16
    max_wait_ms: float = 5.0
    batch_buckets: Tuple[int, ...] = ()  # default: powers of two up to max_batch
    # warmup shape: visual/av "T" or "T,H,W"; audio "samples"; au_patch "T,A,h,w";
    # au_face "T,H,W,Ta,A,h,w". Empty = no warmup.
    warmup: str = ""


def _adapter_for(engine_name: str, scorer):
    from ..serving import batcher as B

    return {
        "visual": B.VisualAdapter,
        "audio": B.AudioAdapter,
        "au_face": B.AUFaceAdapter,
        "au_patch": B.AUPatchAdapter,
        "av": B.AVAdapter,
    }[engine_name](scorer)


def _warmup_payload(cfg: Config) -> dict:
    dims = [int(x) for x in cfg.warmup.split(",")]
    if cfg.engine == "audio":
        (s,) = dims
        return {"waveform": np.zeros((s,), np.float32)}
    if cfg.engine == "au_patch":
        t, a, h, w = dims
        return {"patches": np.zeros((t, a, h, w, 3), np.uint8)}
    if cfg.engine == "au_face":
        t, hh, ww, ta, a, h, w = dims
        return {"video": np.zeros((t, hh, ww, 3), np.uint8),
                "patches": np.zeros((ta, a, h, w, 3), np.uint8)}
    t = dims[0]
    hw = (dims[1], dims[2]) if len(dims) >= 3 else (256, 256)
    payload = {"frames": np.zeros((t,) + hw + (3,), np.uint8)}
    if cfg.engine == "av":
        payload["waveform"] = np.zeros((16000,), np.float32)
    return payload


def main(argv=None, *, log=print, started: Optional[list] = None):
    """Serve until interrupted. ``started`` (a test hook): the live daemon is
    appended to it and returned at once, not blocking; its caller stops it."""
    from ..serving import MicroBatcher, ServingDaemon

    cfg = parse_config(Config, argv, prog="serve_daemon")
    # the engines pad a batch up to a mesh multiple, so a divisor of
    # max_batch bounds the pad waste
    scorer = build_engine(cfg, data_mesh(cfg, cfg.max_batch, log) if cfg.use_mesh else None)
    batcher = MicroBatcher(_adapter_for(cfg.engine, scorer), max_batch=cfg.max_batch,
                           max_wait_ms=cfg.max_wait_ms, batch_buckets=cfg.batch_buckets or None)
    daemon = ServingDaemon({cfg.engine: batcher}, host=cfg.host, port=cfg.port)
    daemon.start()
    log(f"serving engine={cfg.engine} at {daemon.url} "
        f"(max_batch={cfg.max_batch}, max_wait_ms={cfg.max_wait_ms}, "
        f"batch_buckets={list(batcher.batch_buckets)})")
    if cfg.warmup:
        t0 = time.monotonic()
        daemon.warmup(cfg.engine, **_warmup_payload(cfg))
        log(f"warmup done in {time.monotonic() - t0:.1f}s "
            f"({len(batcher.batch_buckets)} batch buckets)")
    if started is not None:
        started.append(daemon)
        return daemon
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        log("shutting down")
    finally:
        daemon.stop()


if __name__ == "__main__":
    main()
