"""The cut's wire records (port of `repro/core/split.py:54-99`).

Only the serving slice's part: `WireRecord` and `record`.  The split
training topologies come with the training slice.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class WireRecord:
    """One payload that crossed the client/server boundary.

    `payload_bytes` overrides the dense shape * itemsize count when wire
    middleware changed the physical representation (int8 + row scales)."""
    name: str
    shape: tuple             # LOGICAL payload shape (pre-pack)
    dtype: torch.dtype       # LOGICAL dtype (what the dense value carries)
    direction: str           # "up" (client->server) | "down"
    payload_bytes: int | None = None
    physical: bool = False   # True: bytes derived from a packed payload

    @property
    def bytes(self) -> int:
        if self.payload_bytes is not None:
            return self.payload_bytes
        n = 1
        for s in self.shape:
            n *= s
        return n * self.dtype.itemsize


def record(wires: list, name: str, t, direction: str):
    """Record one boundary crossing and return the value AS THE OTHER
    SIDE RECEIVES IT.

    `wires` is a plain list (no middleware: `t` passes unchanged) or an
    `api.wire.WireTape`, which runs the wire stack on the value and
    prices the record at the stack's physical bytes.  With a physical
    transform the returned value is the `PackedInt8` payload itself."""
    transform = getattr(wires, "transform", None)
    payload, physical = None, False
    if transform is not None:
        t = transform(t, name, direction)
        payload, physical = wires.payload_bytes(t)
    wires.append(WireRecord(name, tuple(t.shape), t.dtype, direction,
                            payload, physical))
    return t
