"""Structured metric logging: JSONL, and optional wandb and TensorBoard sinks.

Counterpart of ``multimodal_deepfake_detection_tpu/utils/metric_logger.py``:
every train CLI streams one JSON object per epoch to a ``.jsonl`` file
(``--jsonl_log``) and can mirror the same scalars to wandb and/or
TensorBoard through the same logger API (``--tracker``, e.g.
``tensorboard:runs/exp1`` or ``wandb:my_project``). ``log_epoch`` reads the
fields of ``train/loop.py``'s ``EpochResult``, which are the JAX loop's, so
a run of either package writes the same JSONL keys. wandb and TensorBoard
are imported only when their sink is asked for.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Sequence


class JsonlLogger:
    def __init__(self, path: str, *, run_name: Optional[str] = None, config=None):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a")
        header = {"event": "run_start", "time": time.time(), "run": run_name}
        if config is not None:
            if dataclasses.is_dataclass(config):
                config = dataclasses.asdict(config)
            header["config"] = config
        self._write(header)

    @staticmethod
    def _sanitize(obj):
        # NaN/Inf are invalid strict JSON — serialize as null
        if isinstance(obj, dict):
            return {k: JsonlLogger._sanitize(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [JsonlLogger._sanitize(v) for v in obj]
        if isinstance(obj, float) and (obj != obj or obj in (float("inf"), float("-inf"))):
            return None
        return obj

    def _write(self, obj):
        self._f.write(json.dumps(self._sanitize(obj), default=str, allow_nan=False) + "\n")
        self._f.flush()

    def log_epoch(self, result) -> None:
        """Accepts a ``train.loop.EpochResult``."""
        obj = {
            "event": "epoch",
            "time": time.time(),
            "epoch": result.epoch,
            "train_loss": result.train_loss,
            "train_metrics": result.train_metrics,
            "eval_loss": result.eval_loss,
            "eval_metrics": result.eval_metrics,
            "lr": result.lr,
            "seconds": result.seconds,
        }
        self._write(obj)

    def log(self, **scalars) -> None:
        self._write({"event": "scalar", "time": time.time(), **scalars})

    def close(self):
        self._f.close()


def _config_dict(config):
    if config is None:
        return None
    if dataclasses.is_dataclass(config):
        return dataclasses.asdict(config)
    return dict(config)


def _epoch_scalars(result) -> dict:
    """Flatten an EpochResult to the wandb key style (``Loss/Train``,
    ``AUC/Train``, ``Epoch Time``)."""
    scalars = {"Loss/Train": result.train_loss, "Epoch Time": result.seconds}
    if result.lr is not None:
        scalars["LR"] = result.lr
    for k, v in (result.train_metrics or {}).items():
        scalars[f"{k}/Train"] = v
    if result.eval_loss is not None:
        scalars["Loss/Eval"] = result.eval_loss
    for k, v in (result.eval_metrics or {}).items():
        scalars[f"{k}/Eval"] = v
    return {k: v for k, v in scalars.items() if isinstance(v, (int, float))}


class WandbLogger:
    """wandb sink: ``init`` with a project and resume, ``config.update`` of
    the hyperparameters, one ``log`` per epoch."""

    def __init__(self, project: str, *, run_name: Optional[str] = None, config=None):
        try:
            import wandb
        except ImportError as e:
            raise ImportError(
                "wandb is not installed in this environment; use "
                "--tracker tensorboard:<logdir> or --jsonl_log instead"
            ) from e
        self._wandb = wandb
        self._run = wandb.init(project=project, name=run_name, resume=True)
        cfg = _config_dict(config)
        if cfg:
            wandb.config.update(cfg)

    def log_epoch(self, result) -> None:
        self._wandb.log(_epoch_scalars(result), step=result.epoch)

    def log(self, **scalars) -> None:
        self._wandb.log(scalars)

    def close(self):
        self._wandb.finish()


class TensorBoardLogger:
    """TensorBoard sink (torch SummaryWriter) with the same scalar names."""

    def __init__(self, logdir: str, *, run_name: Optional[str] = None, config=None):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "tensorboard is not available; use --jsonl_log instead"
            ) from e
        path = os.path.join(logdir, run_name) if run_name else logdir
        self._writer = SummaryWriter(path)
        cfg = _config_dict(config)
        if cfg:
            self._writer.add_text(
                "config", json.dumps(cfg, default=str, sort_keys=True), 0
            )
        self._step = 0

    def log_epoch(self, result) -> None:
        for k, v in _epoch_scalars(result).items():
            self._writer.add_scalar(k, v, result.epoch)
        self._writer.flush()

    def log(self, **scalars) -> None:
        self._step += 1
        for k, v in scalars.items():
            if isinstance(v, (int, float)):
                self._writer.add_scalar(k, v, self._step)

    def close(self):
        self._writer.close()


class MultiLogger:
    """Fan out the logger API to several sinks."""

    def __init__(self, loggers: Sequence):
        self.loggers = list(loggers)

    def log_epoch(self, result) -> None:
        for lg in self.loggers:
            lg.log_epoch(result)

    def log(self, **scalars) -> None:
        for lg in self.loggers:
            lg.log(**scalars)

    def close(self):
        for lg in self.loggers:
            lg.close()


def make_metric_logger(specs, *, run_name: Optional[str] = None, config=None):
    """Build a logger from sink specs.

    Each spec is ``"jsonl:<path>"``, ``"tensorboard:<logdir>"`` or
    ``"wandb:<project>"`` (comma-separated string or sequence). Returns a
    single logger or a MultiLogger; None if no specs.
    """
    if isinstance(specs, str):
        specs = [s for s in specs.split(",") if s]
    loggers = []
    for spec in specs or []:
        kind, _, arg = spec.partition(":")
        if not arg:
            raise ValueError(f"tracker spec {spec!r} needs an argument, e.g. 'tensorboard:runs'")
        if kind == "jsonl":
            loggers.append(JsonlLogger(arg, run_name=run_name, config=config))
        elif kind == "tensorboard":
            loggers.append(TensorBoardLogger(arg, run_name=run_name, config=config))
        elif kind == "wandb":
            loggers.append(WandbLogger(arg, run_name=run_name, config=config))
        else:
            raise ValueError(f"unknown tracker kind {kind!r} in {spec!r}")
    if not loggers:
        return None
    return loggers[0] if len(loggers) == 1 else MultiLogger(loggers)
