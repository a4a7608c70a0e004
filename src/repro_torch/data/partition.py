"""Client-side data partitioning for the split and federated protocols
(port of `repro/data/partition.py`).

Horizontal: each client holds different *samples* (the paper's Fig. 1,
many small radiology centers).  Vertical: each client holds different
*features/modalities* of the same samples (the paper's §2 third
configuration).

The `*_batches` emitters produce the stacked engine layouts directly,
`(N, B, ...)` for the horizontal schedules and `(K, B, ...)` for the
branch fan-in topologies.

The Dirichlet splits draw with numpy from integer seeds.  The reference
draws those seeds from `jax.random`; here they come from a
`torch.Generator`, or the caller passes the integers themselves, so a
test can hand in the reference's seeds and get its index arrays bitwise.
"""
from __future__ import annotations

import numpy as np
import torch


def _seed(key) -> int:
    """An int seed as given, or one drawn from a `torch.Generator` (in
    [0, 2**31 - 1), the reference's range)."""
    if isinstance(key, torch.Generator):
        return int(torch.randint(0, 2 ** 31 - 1, (), generator=key,
                                 device=key.device))
    return int(key)


def horizontal_partition(batch: dict, n_clients: int) -> list[dict]:
    """Split the leading (sample) axis across clients."""
    n = next(iter(batch.values())).shape[0]
    per = n // n_clients
    assert per > 0, f"batch {n} too small for {n_clients} clients"
    return [{k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            for i in range(n_clients)]


def vertical_partition(batch: dict, modality_keys: list[str],
                       label_holder: int = 0) -> list[dict]:
    """One client per modality key; samples are aligned (same patients).
    Labels ride with `label_holder`'s shard."""
    out = []
    for i, k in enumerate(modality_keys):
        shard = {k: batch[k]}
        if i == label_holder and "labels" in batch:
            shard["labels"] = batch["labels"]
        out.append(shard)
    return out


def dirichlet_label_skew(key, labels, n_clients: int,
                         alpha: float = 0.5) -> list[torch.Tensor]:
    """Non-IID horizontal split: per-class Dirichlet allocation over
    clients.  `key` is the numpy seed or a generator to draw it from.
    Returns one sorted int64 index tensor per client (variable length), on
    the labels' device."""
    device = labels.device if isinstance(labels, torch.Tensor) else "cpu"
    labels = (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
              else np.asarray(labels))
    rng = np.random.default_rng(_seed(key))
    client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for ci, part in enumerate(np.split(idx, cuts)):
            client_idx[ci].extend(part.tolist())
    return [torch.tensor(sorted(ix), dtype=torch.int64, device=device)
            for ix in client_idx]


def dirichlet_client_batches(key, batch: dict, n_clients: int,
                             per_client: int, alpha: float = 0.5) -> dict:
    """Non-IID per-client batches in the stacked engine layout: every
    client draws `per_client` samples from its OWN Dirichlet(alpha) label
    allocation over the pool, resampling with replacement where its
    allocation is smaller (an empty client falls back to the whole pool).
    `key` is a generator, or the pair of numpy seeds (the allocation's,
    the picks'), which the reference draws from `key` and
    `fold_in(key, 1)`.  Returns {k: (N, per_client, ...)}."""
    assert "labels" in batch, "dirichlet_client_batches needs labels"
    k_alloc, k_pick = ((key, key) if isinstance(key, torch.Generator)
                       else key)
    pools = dirichlet_label_skew(k_alloc, batch["labels"], n_clients,
                                 alpha=alpha)
    rng = np.random.default_rng(_seed(k_pick))
    n_total = int(batch["labels"].shape[0])
    picks = []
    for pool in pools:
        pool = pool.cpu().numpy()
        if pool.size == 0:                 # extreme skew: empty client
            pool = np.arange(n_total)
        picks.append(rng.choice(pool, size=per_client,
                                replace=pool.size < per_client))
    idx = np.stack(picks)                                 # (N, per)
    return {k: v[torch.as_tensor(idx, device=v.device)]
            for k, v in batch.items()}


def vertical_modality_batches(batch: dict, modality_keys: list[str]) -> dict:
    """Per-modality vertical split in the branch-topology layout: one
    client per modality key, samples aligned, labels server-held.  All
    modalities must share a feature shape.  Returns {"x": (K, B, ...),
    "labels": (B,)}."""
    shapes = {k: tuple(batch[k].shape) for k in modality_keys}
    if len(set(shapes.values())) != 1:
        raise ValueError(
            f"modalities must share one feature shape, got {shapes}; "
            "project/pad them to a common width first")
    out = {"x": torch.stack([batch[k] for k in modality_keys])}
    if "labels" in batch:
        out["labels"] = batch["labels"]
    return out
