"""What a driver hands back to ``run.py``."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from benchmark.trace import Capture


@dataclasses.dataclass
class Outcome:
    shape: dict
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    # (short name, number, limit): each number compared, beside its limit
    checks: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)
    memory_peak: int = 0
    facts: Dict[str, Any] = dataclasses.field(default_factory=dict)
    capture: Optional[Capture] = None
    # what the timed path produced that the check judged (for tools)
    judged: Any = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _, v, lim in
                                         self.checks)
