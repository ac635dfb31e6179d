"""Label and split metadata of the public deepfake datasets (numpy-free, stdlib only).

The port's copy of the parsers in the JAX package's
``data/video_enhanced.py``: rows ``(path, label, split)`` from

* **FakeAVCeleb** ``meta_data.csv``, in its official schema (a ``type``
  column where ``RealVideo-RealAudio`` is the only real class; ``path`` and
  ``filename`` joined) or a plain ``path,label[,split]`` csv; rows without a
  split get the deterministic 80/10/10 hash split;
* **LAV-DF** ``metadata.json``: entries with ``file``, ``split`` and
  ``n_fakes`` / ``fake_periods``, fake iff any fake period exists.

Splits are ``train``, ``eval`` (``dev``, ``val``) and ``test``.
"""
from __future__ import annotations

import csv
import hashlib
import json
import os
from typing import List, Tuple

_SPLIT_ALIASES = {"train": "train", "dev": "eval", "eval": "eval", "val": "eval", "test": "test"}


def hash_split(key: str, fracs=(0.8, 0.1, 0.1)) -> str:
    """The split of ``key`` by its md5: ``train`` / ``eval`` / ``test`` in ``fracs``."""
    h = int(hashlib.md5(key.encode()).hexdigest(), 16) % 10_000
    if h < fracs[0] * 10_000:
        return "train"
    if h < (fracs[0] + fracs[1]) * 10_000:
        return "eval"
    return "test"


def load_fakeavceleb_csv(csv_path: str) -> List[Tuple[str, int, str]]:
    rows = []
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        fields = [c.strip().lower() for c in reader.fieldnames or []]
        for raw in reader:
            row = {k.strip().lower(): (v or "").strip() for k, v in raw.items()}
            if "type" in fields:  # the official FakeAVCeleb schema
                label = 0 if row.get("type", "").lower() == "realvideo-realaudio" else 1
                path = row.get("path", "")
                vid = row.get("filename", row.get("vid", ""))
                full = os.path.join(path, vid) if vid else path
            else:  # path,label[,split]
                full = row.get("path", "")
                label = 0 if row.get("label", "").lower() in ("0", "real") else 1
            split = _SPLIT_ALIASES.get(row.get("split", "").lower(), None)
            rows.append((full, label, split if split is not None else hash_split(full)))
    return rows


def load_lavdf_json(json_path: str) -> List[Tuple[str, int, str]]:
    with open(json_path) as f:
        meta = json.load(f)
    rows = []
    for entry in meta:
        n_fakes = entry.get("n_fakes", len(entry.get("fake_periods", []) or []))
        split = _SPLIT_ALIASES.get(str(entry.get("split", "train")).lower(), "train")
        rows.append((entry["file"], 1 if n_fakes else 0, split))
    return rows
