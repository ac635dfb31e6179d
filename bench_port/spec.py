"""Finding a cell's files by name.

Everything that belongs to one configuration, traffic mix, engine kind,
traffic generator or per-layer metric sits in a file of its own, found by
the name ``BENCHMARK.json`` or a workload file gives it:

- ``workloads/<cell>.json``: the configuration, the traffic mix, ``chips``,
  ``why`` and the cell's metrics;
- ``configs/<config>.json``: the model as it is run, with its source;
- ``traffic/<mix>.json``: the mix's parameters and the generator that reads
  them; ``traffic/<generator>.py``: that generator;
- ``engines/<engine>.py``: how a configuration's engine is built, fed,
  checked and counted;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

A later cell, configuration or metric is a new file; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(folder: str, name: str) -> dict:
    path = ROOT / folder / f"{_checked(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def _module(folder: str, name: str) -> ModuleType:
    path = ROOT / folder / f"{_checked(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_port.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name: str) -> dict:
    return _json("workloads", name)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def generator(name: str) -> ModuleType:
    return _module("traffic", name)


def engine(name: str) -> ModuleType:
    return _module("engines", name)


def metric(name: str) -> ModuleType:
    return _module("metrics", name)


def names(folder: str, suffix: str) -> list:
    """The names of every file of ``folder`` with ``suffix``."""
    return sorted(p.name[: -len(suffix)] for p in (ROOT / folder).glob(f"*{suffix}")
                  if not p.name.startswith("_"))
