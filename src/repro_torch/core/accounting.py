"""Resource accounting (port of `repro/core/accounting.py:52-66`).

Only `TurnCost`, which prices the serving engine's wire records; the
training meters come with the training slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TurnCost:
    """Static cost of one turn: its wire records, client flops and the
    p2p weight-handoff bytes."""
    wires: tuple            # tuple[WireRecord]
    flops: float
    sync_bytes: int

    @property
    def bytes_up(self) -> int:
        return sum(w.bytes for w in self.wires if w.direction == "up")

    @property
    def bytes_down(self) -> int:
        return sum(w.bytes for w in self.wires if w.direction == "down")
