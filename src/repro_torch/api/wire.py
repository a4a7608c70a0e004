"""Wire middleware applied at the cut (port of `repro/api/wire.py`).

A `WireTransform` is a named pair of functions:

  apply(t, name, direction) -> t'  — applied to every value the moment
      it crosses the client/server boundary;
  bytes_fn(shape, dtype, nbytes) -> nbytes'  — what the transform does
      to the physical byte count of one payload.

`quantize_int8()` fake-quantizes in plain torch; `quantize_int8(
physical=True)` makes the crossing value the packed `(int8, fp32 row
scales)` payload through the wire kernels, and `WireTape` then derives
the metered bytes from the payload's real tensors and checks them
against the `bytes_fn` claim (`WireAccountingError` on drift).

Both flavours also squeeze the round-robin p2p weight handoff
(`handoff=True`): the previously trained client's weights cross the same
per-row int8 wire, leaf by leaf, before the next client adopts them.
The baselines' model pull and push cross the whole stack leaf by leaf
too (`tree_wire_bytes` prices them).

`leakage_probe()` is the identity on the wire; it marks the stack so
`Session.leakage_report` measures the distance correlation between raw
client inputs and what crosses after the other transforms.  `dp_noise`
adds Gaussian noise to every crossing value, keyed by a seed, the wire's
name and the payload's content.  `with_wire` routes a topology's grad
paths through a stack.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Sequence

import torch

from repro_torch.core.privacy import distance_correlation
from repro_torch.core.wire_compress import (_fake_quant_int8, as_dense,
                                            pack_int8, pack_like,
                                            payload_nbytes, wire_bytes)
from repro_torch.engine.topology import Topology
from repro_torch.nn.module import mix_seed, tree_leaves, tree_map


class WireAccountingError(AssertionError):
    """Metered wire bytes drifted from the physical payload's nbytes."""


@dataclasses.dataclass(frozen=True)
class WireTransform:
    """One middleware layer on the cut wire."""
    name: str
    apply: Callable          # (t, name, direction) -> t
    bytes_fn: Callable       # (shape, dtype, nbytes) -> nbytes
    probe: bool = False      # True: offline-probe-only (identity on wire)
    physical: bool = False   # True: apply() emits the packed payload
    handoff: bool = False    # True: also squeezes the p2p weight handoff


def _identity_bytes(shape, dtype, nbytes):
    return nbytes


def quantize_int8(*, physical: bool = False) -> WireTransform:
    """Per-row symmetric int8 quantization of everything that crosses,
    the p2p weight handoff included.  physical=False fake-quants (float
    values, int8 information content); physical=True packs through the
    wire kernels.  Both ship 1 byte per element + one fp32 scale per
    last-axis row."""
    if physical:
        apply = lambda t, name, direction: pack_int8(as_dense(t))
    else:
        apply = lambda t, name, direction: _fake_quant_int8(as_dense(t))
    return WireTransform(
        name="quantize_int8", apply=apply,
        bytes_fn=lambda shape, dtype, nbytes: wire_bytes(
            shape, quantized=True, base_dtype=dtype),
        physical=physical, handoff=True)


def name_key(name: str) -> int:
    """The wire name's share of a `dp_noise` key, as the reference folds
    it in: crc32 of the name, cleared to 31 bits."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def content_hash(d: torch.Tensor) -> torch.Tensor:
    """The payload's share of a `dp_noise` key: the wrapping uint32 sum of
    its float32 bits (the reference's `bits.sum(dtype=uint32)`), as an
    int64 0-d tensor on the payload's device.  A signed int32 view sums to
    the same value mod 2**32."""
    bits = d.float().contiguous().view(torch.int32).to(torch.int64)
    return bits.sum() & 0xFFFFFFFF


def dp_noise(sigma: float, seed: int = 0) -> WireTransform:
    """Gaussian noise of standard deviation `sigma` on every crossing value
    (DP-style masking of the wire).  Deterministic: the noise is drawn
    from a generator on the payload's device seeded from `seed`, the
    wire's name (`name_key`) and the payload's content (`content_hash`),
    the three words the reference keys `jax.random` with, so each turn and
    payload draws different noise without a key threaded through the
    engine.  Torch cannot draw JAX's normals, so only the key's words
    match the reference's.  Reading the content hash is one host sync a
    crossing.  Downstream of a physical quantizer the noised value is
    re-packed, so the wire stays int8 (one more quantize and dequantize a
    crossing).  The bytes and the p2p handoff are unchanged."""
    def apply(t, name, direction):
        d = as_dense(t)
        if d.device.type == "meta":          # a shape probe: nothing to key
            return pack_like(t, d)
        gen = torch.Generator(device=d.device).manual_seed(
            mix_seed(seed, name_key(name), int(content_hash(d))))
        noise = torch.randn(d.shape, generator=gen, dtype=d.dtype,
                            device=d.device)
        return pack_like(t, d + sigma * noise)

    return WireTransform(name="dp_noise", apply=apply,
                         bytes_fn=_identity_bytes)


def leakage_probe() -> WireTransform:
    """Identity on the wire; marks the stack so `Session.leakage_report`
    computes the distance correlation between raw client inputs and
    what crosses AFTER the other transforms.  Kept out of the training
    round: the O(B^2) dcor matrices belong in an offline probe."""
    return WireTransform(name="leakage_probe",
                         apply=lambda t, name, direction: t,
                         bytes_fn=_identity_bytes, probe=True)


def parse_wire(spec) -> tuple:
    """'quantize_int8' / 'quantize_int8:physical' / 'dp_noise:SIGMA' /
    'leakage_probe', comma-separated -> transform tuple (`dp_noise`
    alone takes sigma 0.05).
    Also takes a built `WireStack`, a sequence of `WireTransform`s, or
    None / "" (the empty stack)."""
    if spec is None:
        return ()
    if isinstance(spec, WireStack):
        return spec.transforms
    if not isinstance(spec, str):
        return tuple(spec)
    out = []
    for tok in filter(None, spec.split(",")):
        name, _, arg = tok.partition(":")
        if name == "quantize_int8":
            if arg not in ("", "physical", "fake"):
                raise ValueError(f"quantize_int8:{arg}? (physical|fake)")
            out.append(quantize_int8(physical=arg == "physical"))
        elif name == "dp_noise":
            out.append(dp_noise(float(arg or 0.05)))
        elif name == "leakage_probe":
            out.append(leakage_probe())
        else:
            raise ValueError(f"unknown wire transform {name!r}")
    return tuple(out)


class WireStack:
    """An ordered stack of `WireTransform`s, applied at every crossing."""

    def __init__(self, transforms: Sequence[WireTransform]):
        self.transforms = tuple(transforms)

    def __bool__(self):
        return bool(self.transforms)

    @property
    def physical(self) -> bool:
        return any(tr.physical for tr in self.transforms)

    @property
    def has_handoff(self) -> bool:
        return any(tr.handoff for tr in self.transforms)

    def apply(self, t, name: str, direction: str):
        for tr in self.transforms:
            t = tr.apply(t, name, direction)
        return t

    def wire_bytes(self, shape, dtype) -> int:
        """Physical bytes of one payload after the whole stack — the
        `bytes_fn` claim."""
        n = 1
        for s in shape:
            n *= s
        nbytes = n * dtype.itemsize
        for tr in self.transforms:
            nbytes = tr.bytes_fn(tuple(shape), dtype, nbytes)
        return int(nbytes)

    def tree_wire_bytes(self, tree) -> int:
        """Full-stack wire bytes of a whole payload tree, leafwise: prices
        the baselines' model pull and push through the stack."""
        return sum(self.wire_bytes(tuple(leaf.shape), leaf.dtype)
                   for leaf in tree_leaves(tree))

    # ---- p2p weight handoff ------------------------------------------------

    def _handoff_transforms(self) -> list:
        return [tr for tr in self.transforms if tr.handoff]

    def handoff_recv(self, tree):
        """What the next client ADOPTS after the p2p handoff crossed the
        wire: every leaf squeezed through the handoff transforms (dense in,
        dense out; the fake and physical flavours give bitwise the same
        values).  A 0-d leaf crosses as a one-element row."""
        fns = self._handoff_transforms()
        if not fns:
            return tree

        def leaf(a):
            for tr in fns:
                a = as_dense(tr.apply(a, "p2p_handoff", "p2p"))
            return a

        return tree_map(leaf, tree)

    def handoff_pack(self, tree):
        """The handoff's transport form, quantized once at the source:
        packed int8 leaves when the stack is physical, the fake-quantized
        dense tree otherwise.  `handoff_unpack(handoff_pack(x))` is
        bitwise `handoff_recv(x)` in both flavours."""
        if not self.has_handoff:
            return tree
        if self.physical:
            return tree_map(pack_int8, tree)
        return self.handoff_recv(tree)

    def handoff_unpack(self, tree):
        return tree_map(as_dense, tree)

    def handoff_bytes(self, tree) -> int:
        """Wire bytes of one p2p handoff payload, priced leafwise through
        the handoff transforms' `bytes_fn`s."""
        fns = self._handoff_transforms()
        total = 0
        for leaf in tree_leaves(tree):
            shape, dtype = tuple(leaf.shape), leaf.dtype
            nbytes = leaf.numel() * dtype.itemsize
            for tr in fns:
                nbytes = tr.bytes_fn(shape, dtype, nbytes)
            total += int(nbytes)
        return total

    # ---- probes ------------------------------------------------------------

    def pre_probe(self, t, name: str = "probe", direction: str = "up"):
        """Apply only the non-probe transforms (what the wire carries
        when the offline leakage probe inspects it), densified for the
        dcor math."""
        for tr in self.transforms:
            if not tr.probe:
                t = tr.apply(t, name, direction)
        return as_dense(t)

    def leakage(self, x_raw, wire_value) -> float:
        return float(distance_correlation(x_raw, wire_value))


class WireTape(list):
    """A `WireRecord` list that `core.split.record` recognises: values are
    transformed and records priced at the stack's physical wire bytes."""

    def __init__(self, stack: WireStack):
        super().__init__()
        self.stack = stack

    def transform(self, t, name: str, direction: str):
        return self.stack.apply(t, name, direction)

    def payload_bytes(self, t) -> tuple:
        """(bytes, physical) for the transformed wire value `t`; with a
        physical stack the bytes come from the payload's tensors and must
        equal the `bytes_fn` claim."""
        predicted = self.stack.wire_bytes(tuple(t.shape), t.dtype)
        if self.stack.physical:
            actual = payload_nbytes(t)
            if actual != predicted:
                raise WireAccountingError(
                    f"metered wire bytes drifted from the physical "
                    f"payload: bytes_fn claims {predicted}, the packed "
                    f"payload holds {actual} (shape {tuple(t.shape)}, "
                    f"dtype {t.dtype})")
            return actual, True
        return predicted, False


def with_wire(topology: Topology, stack: WireStack) -> Topology:
    """Wrap a topology so its grad paths run every boundary value through
    `stack`: the training `turn_grads` / `round_grads` and the staged
    `pipeline_rest` (a fresh tape per call in place of its `wires`;
    records discarded, values transformed) and the metering
    `turn_grads_wires` (the caller's list receives the stack-priced
    records)."""
    if not stack:
        return topology
    fn = topology.turn_grads_wires

    def wired(*args):
        *head, wires = args
        tape = WireTape(stack)
        out = fn(*head, tape)
        wires.extend(tape)
        return out

    def taped(*args):
        return fn(*args, WireTape(stack))

    def tape_rest(rest):
        return lambda *args: rest(*args[:-1], WireTape(stack))

    return dataclasses.replace(
        topology, turn_grads_wires=wired,
        turn_grads=None if topology.turn_grads is None else taped,
        round_grads=None if topology.round_grads is None else taped,
        pipeline_rest=(None if topology.pipeline_rest is None
                       else tape_rest(topology.pipeline_rest)))
