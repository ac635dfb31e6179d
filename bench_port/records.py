"""What a traffic generator hands the harness: the plan it made from the
seed before the window, and the record of the window."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple


@dataclass
class Plan:
    """``clips``: every distinct clip the traffic sends, by key, as the
    reference scores it (its valid part); ``data``: the generator's own."""
    clips: Dict[Any, Any]
    data: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Window:
    """One measured window.

    ``answers``: (clip key, score) for every answer that came; ``missing``:
    the clip keys of requests that never got one (failed or never came);
    ``end_to_end``: the cell's end-to-end metrics by name; ``calls``: the
    host-clock seconds of each engine call; ``info``: readings for the
    earlier lines."""
    seconds: float
    attempted: int
    answers: List[Tuple[Any, float]]
    missing: List[Any]
    end_to_end: Dict[str, float]
    calls: List[float] = field(default_factory=list)
    info: Dict[str, Any] = field(default_factory=dict)

    @property
    def failed(self) -> int:
        return len(self.missing)

