"""Deterministic synthetic datasets on explicit generators (port of
`repro/data/synthetic.py:18-62`).

No dataset downloads.  Each function draws from the `torch.Generator` it
is given, on the generator's device; the class structure (templates,
class weights) comes from generators with FIXED seeds, so every batch
shares it.  The numbers differ from the reference's `jax.random` draws:
parity tests hand both packages the same numpy batches.
"""
from __future__ import annotations

import torch


def _fixed(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def lm_batch(gen: torch.Generator, batch: int, seq: int, vocab: int):
    """A noisy bigram process, next = (5 * cur + noise) % vocab with noise
    in [0, 7), so LM training loss demonstrably falls: {"tokens",
    "labels"}, each (batch, seq) int64, labels the tokens shifted by
    one."""
    dev = gen.device
    cur = torch.randint(0, vocab, (batch,), generator=gen, device=dev)
    noise = torch.randint(0, 7, (batch, seq), generator=gen, device=dev)
    toks = [cur]
    for t in range(seq):
        cur = (5 * cur + noise[:, t]) % vocab
        toks.append(cur)
    toks = torch.stack(toks, dim=1)                      # (B, S+1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lm_stream(gen: torch.Generator, batch: int, seq: int, vocab: int):
    """An endless stream of `lm_batch`es drawn from `gen`."""
    while True:
        yield lm_batch(gen, batch, seq, vocab)


def image_batch(gen: torch.Generator, batch: int, n_classes: int,
                hw: int = 32, ch: int = 3, noise: float = 0.6):
    """Class-conditional NHWC images: a fixed random template per class
    (seed 1234) plus `noise` times standard normals."""
    dev = gen.device
    templates = torch.randn((n_classes, hw, hw, ch),
                            generator=_fixed(1234, dev), device=dev)
    labels = torch.randint(0, n_classes, (batch,), generator=gen, device=dev)
    x = templates[labels] + noise * torch.randn((batch, hw, hw, ch),
                                                generator=gen, device=dev)
    return {"images": x, "labels": labels}


def multimodal_batch(gen: torch.Generator, batch: int, n_classes: int,
                     dim_a: int = 64, dim_b: int = 48, noise: float = 0.5):
    """Vertically-partitioned tabular data: two feature blocks (e.g.
    'radiology' and 'pathology'), each individually weakly predictive,
    jointly strongly predictive — the paper's multi-modal setting."""
    dev = gen.device
    wa = torch.randn((n_classes, dim_a), generator=_fixed(77, dev),
                     device=dev)
    wb = torch.randn((n_classes, dim_b), generator=_fixed(78, dev),
                     device=dev)
    labels = torch.randint(0, n_classes, (batch,), generator=gen, device=dev)
    xa = wa[labels] + noise * torch.randn((batch, dim_a), generator=gen,
                                          device=dev)
    xb = wb[labels] + noise * torch.randn((batch, dim_b), generator=gen,
                                          device=dev)
    return {"mod_a": xa, "mod_b": xb, "labels": labels}
