"""Batching: a host-side pipeline with a placement hook (port of
`repro/data/pipeline.py`)."""
from __future__ import annotations

from typing import Callable, Iterator


class DataPipeline:
    """Wraps a batch generator, keeping `prefetch` batches placed ahead.

    `shard_fn` places each batch (`sharded_put`: a fleet rank's slice on
    its device); the default leaves it as it is."""

    def __init__(self, gen: Iterator[dict], shard_fn: Callable | None = None,
                 prefetch: int = 2):
        self._gen = gen
        self._shard = shard_fn or (lambda b: b)
        self._buf: list[dict] = []
        self._prefetch = prefetch

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        """The next placed batch.  The last `prefetch - 1` batches come out
        too (the reference's loop raises StopIteration while they wait in
        its buffer)."""
        for batch in self._gen:
            self._buf.append(self._shard(batch))
            if len(self._buf) >= self._prefetch:
                break
        if not self._buf:
            raise StopIteration
        return self._buf.pop(0)


def sharded_put(mesh, spec_map: dict) -> Callable:
    """The `shard_fn` of a fleet rank (`launch.mesh.FleetMesh`): each key
    of `spec_map` mapped to the client axis (`mesh.axis_names[0]`) keeps
    the rank's slice of its leading axis, and moves to the rank's device
    with every other mapped key (mapped to `()`: whole on every rank);
    keys not in `spec_map` pass through.  The fleet engines take such a
    slice as the rank's share of a round's batches."""
    axis, n_ranks = mesh.axis_names[0], mesh.shape[mesh.axis_names[0]]

    def fn(batch: dict) -> dict:
        out = dict(batch)
        for k, spec in spec_map.items():
            v = batch[k]
            if spec == axis:
                if v.shape[0] % n_ranks:
                    raise ValueError(
                        f"sharded_put: {k}'s client axis {v.shape[0]} does "
                        f"not divide over {n_ranks} ranks")
                n = v.shape[0] // n_ranks
                v = v[mesh.rank * n:(mesh.rank + 1) * n]
            out[k] = v.to(mesh.device)
        return out
    return fn
