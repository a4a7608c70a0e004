"""The port's vanilla split training (N clients round-robin with the p2p
weight handoff) against the JAX reference, on the CPU.

Inputs are seeded numpy arrays handed to both packages; parameters and
whole engine states come from the JAX side through `repro_torch.bridge`.
The model is the smoke VGG (`configs/vgg_cifar10.py:SMOKE`) cut after
its second conv, 3 clients.  Everything is fp32 with TF32 off.
Tolerances, each with its reason:

* the fake wire's custom VJP, the handoff payloads (int8 `q`, row scales
  and what the next client adopts) and the cut's packed payload given
  the same dense value: BITWISE (the same arithmetic on the same inputs);
* gradients of one split step: rtol = 1e-5, atol = 1e-6, and losses,
  evaluation logits and states after 3 rounds: rtol = atol = 1e-5 (the
  two frameworks sum convolutions in different orders);
* leakage (distance correlation over 64 rows): rtol = atol = 1e-4, as in
  `tests/test_torch_train.py`;
* wire records, wire reports, handoff bytes and metered bytes: exactly
  equal;
* FLOPs: the ratio of torch's counter to XLA's cost model is held to the
  band measured here (`FLOP_RATIO_BAND`, written in PERF.md), as
  `tests/test_torch_train.py` holds the vertical slice's.

A quantized wire rounds each crossing value to one of 255 levels, so a
value within the frameworks' fp32 difference of a rounding boundary would
round differently in the two; the seeds below put none there.  Training
runs AdamW at the `Plan` default of 1e-3: at 5e-3 one server weight whose
gradient is near zero (where Adam divides two tiny moments) drifts 5.7e-5
apart in round 3 of the quantized wires, while every other leaf stays
within 3e-6 of the reference relative to its scale.

The test marked `gpu` trains on the card against the CPU and skips
without a CUDA GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.api import Plan as JPlan
from repro.api import leakage_probe as jleakage_probe
from repro.api import quantize_int8 as jquantize_int8
from repro.api import softmax_xent as jsoftmax_xent
from repro.api.wire import WireStack as JWireStack
from repro.api.wire import WireTape as JWireTape
from repro.configs import vgg_cifar10 as jvgg_cfg
from repro.core import split as jsp
from repro.core import wire_compress as jwc
from repro.engine import topology as jtopo
from repro.nn import convnets as JC
from repro_torch import bridge, optim
from repro_torch.api import (FleetRoundEngine, FleetSpec, Plan, SplitFns,
                             WireStack, WireTape, leakage_probe,
                             quantize_int8, softmax_xent)
from repro_torch.configs import vgg_cifar10 as tvgg_cfg
from repro_torch.core import split as sp
from repro_torch.core import wire_compress as twc
from repro_torch.engine import program as ir
from repro_torch.engine import topology as topo
from repro_torch.nn import convnets as TC
from repro_torch.nn import module as tmod
from _torch_threads import one_torch_thread

one_torch_thread()

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
LEAK_TOL = dict(rtol=1e-4, atol=1e-4)
# torch counter FLOPs / XLA cost-model FLOPs of the client forward (two
# 3x3 convs at 32 x 32), as measured by test_vanilla_flops_ratio_to_xla
FLOP_RATIO_BAND = (1.02, 1.03)
CUT, N_CLIENTS, ROUNDS, HW = 2, 3, 3, 32


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees(t_tree, j_tree, tol=None):
    """Leafwise: allclose at `tol`, or bitwise where `tol` is None."""
    t_leaves = jax.tree_util.tree_leaves(bridge.tree_to_numpy(t_tree))
    j_leaves = jax.tree_util.tree_leaves(_np_tree(j_tree))
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.shape == b.shape
        if tol is None:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **tol)


def _models():
    cj, ct = jvgg_cfg.SMOKE, tvgg_cfg.SMOKE
    plan_j, plan_t = JC.vgg_plan(cj), TC.vgg_plan(ct)
    assert plan_j == plan_t
    jm = jsp.list_segmodel(len(plan_j), lambda k: JC.vgg_init(k, cj),
                           lambda p, i, x: JC.vgg_layer_apply(p, plan_j[i], x))
    tm = sp.list_segmodel(len(plan_t), lambda g: TC.vgg_init(g, ct),
                          lambda p, i, x: TC.vgg_layer_apply(p, plan_t[i], x))
    return jm, tm


def _params(seed=4):
    """The reference's smoke VGG with non-zero biases (so the bias paths
    and their handoff rows are compared too), as (jax tree, port tree)."""
    pj = JC.vgg_init(jax.random.PRNGKey(seed), jvgg_cfg.SMOKE)
    pj = jax.tree_util.tree_map(lambda a: a + 0.1 if a.ndim == 1 else a, pj)
    return pj, bridge.tree_from_jax(_np_tree(pj))


def _batch(seed, lead, n_classes=4):
    """{"x": lead + (HW, HW, 3), "labels": lead} in both packages: a fixed
    template per class plus 0.6 noise, the recipe of
    `data/synthetic.py:image_batch`, so three rounds can learn."""
    rng = np.random.default_rng(seed)
    templates = np.random.default_rng(1234).standard_normal(
        (n_classes, HW, HW, 3))
    labels = rng.integers(0, n_classes, lead)
    x = (templates[labels] + 0.6 * rng.standard_normal(
        lead + (HW, HW, 3))).astype(np.float32)
    return ({"x": jnp.asarray(x), "labels": jnp.asarray(labels, jnp.int32)},
            {"x": torch.from_numpy(x), "labels": torch.from_numpy(labels)})


WIRES = {"dense": (lambda: [], lambda: []),
         "fake": (lambda: [jquantize_int8()], lambda: [quantize_int8()]),
         "physical": (lambda: [jquantize_int8(physical=True),
                               jleakage_probe()],
                      lambda: [quantize_int8(physical=True),
                               leakage_probe()])}


def _records(wires):
    return [(w.name, tuple(w.shape), str(w.dtype).replace("torch.", ""),
             w.direction, w.bytes, w.physical) for w in wires]


# ---------------------------------------------------------------------------
# the fake wire's custom VJP and the segmented model
# ---------------------------------------------------------------------------

QW_SHAPES = [(), (7,), (5, 33), (2, 3, 64)]


@pytest.mark.parametrize("shape", QW_SHAPES, ids=[str(s) for s in QW_SHAPES])
def test_quantized_wire_value_and_gradient_match_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = np.asarray(rng.standard_normal(shape) * 3, np.float32)
    ct = np.asarray(rng.standard_normal(shape) * 1e-3, np.float32)
    yj, vjp = jax.vjp(jwc.quantized_wire, jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(ct))
    leaf = torch.from_numpy(x).requires_grad_()
    yt = twc.quantized_wire(leaf)
    (gt,) = torch.autograd.grad(yt, leaf, torch.from_numpy(ct))
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert tuple(yt.shape) == shape and tuple(gt.shape) == shape
    if shape:       # a row of several: the cotangent is quantized
        assert not np.array_equal(gt.numpy(), ct)


def test_list_segmodel_apply_range_matches_reference():
    """Layer by layer, then the client's range and the server's range
    with and without `offset`."""
    jm, tm = _models()
    assert tm.n_segments == jm.n_segments == 7
    assert sp._takes_offset(tm) and jsp._takes_offset(jm)
    pj, pt = _params()
    xj, xt = _batch(5, (2,))
    aj, at = xj["x"], xt["x"]
    for i in range(jm.n_segments):
        aj = jm.apply_range(pj, aj, i, i + 1)
        at = tm.apply_range(pt, at, i, i + 1)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), **TOL)
        at = torch.from_numpy(np.array(aj))      # each layer on equal input
    cj = jm.apply_range(pj, xj["x"], 0, CUT)
    ct = tm.apply_range(pt, xt["x"], 0, CUT)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    ps_j = jm.param_slice(pj, CUT, jm.n_segments)
    ps_t = tm.param_slice(pt, CUT, tm.n_segments)
    assert len(ps_t) == len(ps_j) == jm.n_segments - CUT
    a = torch.from_numpy(np.array(cj))
    want = np.asarray(jm.apply_range(ps_j, cj, CUT, jm.n_segments,
                                     offset=CUT))
    np.testing.assert_allclose(
        tm.apply_range(ps_t, a, CUT, tm.n_segments, offset=CUT).numpy(),
        want, **TOL)
    np.testing.assert_allclose(
        tm.apply_range(pt, a, CUT, tm.n_segments).numpy(), want, **TOL)
    joined = tm.param_join([tm.param_slice(pt, 0, CUT), ps_t])
    assert all(a is b for a, b in zip(tmod.tree_leaves(joined),
                                      tmod.tree_leaves(pt)))


# ---------------------------------------------------------------------------
# one split step's gradients
# ---------------------------------------------------------------------------

def _tapes(wire):
    jw, tw = WIRES[wire]
    return (JWireTape(JWireStack(jw())) if jw() else [],
            WireTape(WireStack(tw())) if tw() else [])


def _split_step(wire, seed=8, tapes=None):
    jm, tm = _models()
    pj, pt = _params()
    bj, bt = _batch(seed, (8,))
    tape_j, tape_t = tapes or _tapes(wire)
    out_j = jsp.vanilla_split_grads(
        jm, CUT, pj[:CUT], pj[CUT:], bj["x"], bj["labels"], jsoftmax_xent,
        tape_j)
    out_t = sp.vanilla_split_grads(
        tm, CUT, pt[:CUT], pt[CUT:], bt["x"], bt["labels"], softmax_xent,
        tape_t)
    return out_j, out_t, (pj, pt), (bj, bt)


@pytest.mark.parametrize("wire", list(WIRES))
def test_vanilla_split_grads_match_reference(wire):
    (loss_j, gc_j, gs_j, tape_j), (loss_t, gc_t, gs_t, tape_t), _, _ = \
        _split_step(wire)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **GRAD_TOL)
    _assert_trees(gc_t, gc_j, GRAD_TOL)
    _assert_trees(gs_t, gs_j, GRAD_TOL)
    assert _records(tape_t) == _records(tape_j)
    assert [r[0] for r in _records(tape_t)] == ["cut_act", "cut_grad"]
    assert [r[3] for r in _records(tape_t)] == ["up", "down"]
    assert all(r[1] == (8, HW, HW, 8) for r in _records(tape_t))
    assert all(r[5] == (wire == "physical") for r in _records(tape_t))
    want = 8 * HW * HW * 8 * (4 if wire == "dense" else 1) + (
        0 if wire == "dense" else 8 * HW * HW * 4)
    assert all(r[4] == want for r in _records(tape_t))


class _Capture:
    """A wire tape that also keeps (name, value sent, value received) of
    every crossing."""
    def transform(self, t, name, direction):
        out = super().transform(t, name, direction)
        self.values = getattr(self, "values", []) + [(name, t, out)]
        return out


class _CaptureJ(_Capture, JWireTape):
    pass


class _CaptureT(_Capture, WireTape):
    pass


def test_cut_payload_packs_bitwise_like_the_reference():
    """The packed payloads at the cut: what the reference packs, the port
    packs to the same int8 `q` and row scales, bitwise, for the
    activation going up and the gradient coming down; and the values the
    two packages hand the wire agree to fp32 tolerance."""
    tapes = (_CaptureJ(JWireStack([jquantize_int8(physical=True)])),
             _CaptureT(WireStack([quantize_int8(physical=True)])))
    _split_step("physical", tapes=tapes)
    for (nj, dj, pj), (nt, dt, pt) in zip(tapes[0].values, tapes[1].values,
                                           strict=True):
        assert nj == nt
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj),
                                   rtol=1e-5, atol=1e-9)
        own = twc.pack_int8(torch.from_numpy(np.array(dj)))
        np.testing.assert_array_equal(own.q.numpy(), np.asarray(pj.q))
        np.testing.assert_array_equal(own.scale.numpy(), np.asarray(pj.scale))
        assert pt.q.dtype == torch.int8 and pt.scale.dtype == torch.float32
        assert tuple(pt.q.shape) == tuple(pj.q.shape)
        assert tuple(pt.scale.shape) == tuple(pj.scale.shape)
        assert int((pt.q.to(torch.int32) - torch.from_numpy(
            np.array(pj.q)).to(torch.int32)).abs().max()) <= 1


def test_no_gradient_flows_through_the_wire():
    """Each side runs its own graph: the client backpropagates the
    gradient it RECEIVED (the fake-quantized server gradient), not the
    server's own, and no parameter is left in an autograd graph."""
    _, tm = _models()
    _, pt = _params()
    _, bt = _batch(9, (8,))
    tape = _CaptureT(WireStack([quantize_int8()]))
    _, g_c, _, _ = sp.vanilla_split_grads(
        tm, CUT, pt[:CUT], pt[CUT:], bt["x"], bt["labels"], softmax_xent,
        tape)
    assert all(not t.requires_grad for t in tmod.tree_leaves(pt))
    assert all(not t.requires_grad for t in tmod.tree_leaves(g_c))
    (_, g_sent, g_recv) = tape.values[1]
    assert not torch.equal(g_sent, g_recv)

    def client_grad(g_act):
        with torch.enable_grad():
            leaves = sp._leaf_params(pt[:CUT])
            a = tm.apply_range(leaves, bt["x"], 0, CUT)
            return sp._grads(a, leaves, g_act)
    for a, b in zip(tmod.tree_leaves(g_c),
                    tmod.tree_leaves(client_grad(g_recv))):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(
        tmod.tree_leaves(g_c), tmod.tree_leaves(client_grad(g_sent))))


# ---------------------------------------------------------------------------
# the p2p handoff middleware
# ---------------------------------------------------------------------------

HANDOFF_BYTES = 324 + 12 + 864 + 12 + 5     # 4 VGG leaves + a 0-d leaf


@pytest.mark.parametrize("physical", [False, True], ids=["fake", "physical"])
def test_handoff_matches_reference_bitwise(physical):
    """A VGG client tree plus a 0-d leaf: what the next client adopts,
    the packed transport form and its bytes, against the reference."""
    pj, pt = _params()
    tj = {"client": pj[:CUT], "t": jnp.float32(-0.37)}
    tt = {"client": pt[:CUT], "t": torch.tensor(-0.37)}
    sj = JWireStack([jquantize_int8(physical=physical), jleakage_probe()])
    st = WireStack([quantize_int8(physical=physical), leakage_probe()])
    assert st.has_handoff and sj.has_handoff
    recv_t = st.handoff_recv(tt)
    _assert_trees(recv_t, sj.handoff_recv(tj))
    assert tuple(recv_t["t"].shape) == ()
    packed_t, packed_j = st.handoff_pack(tt), sj.handoff_pack(tj)
    leaves_j = jax.tree_util.tree_leaves(
        packed_j, is_leaf=lambda a: isinstance(a, jwc.PackedInt8))
    leaves_t = tmod.tree_leaves(packed_t)
    assert len(leaves_t) == len(leaves_j) == 5
    for a, b in zip(leaves_t, leaves_j):
        assert isinstance(a, twc.PackedInt8) == physical
        if physical:
            np.testing.assert_array_equal(a.q.numpy(), np.asarray(b.q))
            np.testing.assert_array_equal(a.scale.numpy(),
                                          np.asarray(b.scale))
            assert a.q.dtype == torch.int8
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _assert_trees(st.handoff_unpack(packed_t), sj.handoff_unpack(packed_j))
    _assert_trees(st.handoff_unpack(packed_t), recv_t)
    assert st.handoff_bytes(tt) == sj.handoff_bytes(tj) == HANDOFF_BYTES
    dense = WireStack([leakage_probe()])
    assert not dense.has_handoff
    assert dense.handoff_recv(tt) is tt and dense.handoff_pack(tt) is tt
    assert dense.handoff_bytes(tt) == 4 * (216 + 8 + 576 + 8 + 1)


# ---------------------------------------------------------------------------
# Plan(mode="vanilla") end to end
# ---------------------------------------------------------------------------

def _sessions(wire, sync="p2p", lr=1e-3):
    jm, tm = _models()
    jw, tw = WIRES[wire]
    jsess = JPlan(mode="vanilla", model=jm, cut=CUT, n_clients=N_CLIENTS,
                  sync=sync, optimizer=joptim.adamw(lr), wire=jw()).compile()
    jsess.init(jax.random.PRNGKey(0))
    tsess = Plan(mode="vanilla", model=tm, cut=CUT, n_clients=N_CLIENTS,
                 sync=sync, optimizer=optim.adamw(lr),
                 wire=tw()).compile(device="cpu")
    tsess.state = bridge.tree_from_jax(_np_tree(jsess.state))
    # ROUNDS rounds of per-client batches of 8, then a 64-row evaluation
    # batch (the distance correlation needs tens of rows for 1e-4)
    batches = [_batch(100 + r, (N_CLIENTS, 8)) for r in range(ROUNDS)]
    return jsess, tsess, batches, _batch(100 + ROUNDS, (64,))


FIT_CASES = [(w, s) for s in ("p2p", "none") for w in WIRES]


@pytest.fixture(scope="module", params=FIT_CASES,
                ids=[f"{w}-{s}" for w, s in FIT_CASES])
def fitted(request):
    wire, sync = request.param
    jsess, tsess, batches, ev = _sessions(wire, sync)
    lj = [np.asarray(jsess.run_round(b[0])) for b in batches]
    lt = [tsess.run_round(b[1]).numpy() for b in batches]
    return wire, sync, jsess, tsess, batches, ev, lj, lt


def test_vanilla_fit_losses_and_state_match_reference(fitted):
    _, _, jsess, tsess, _, _, lj, lt = fitted
    assert all(a.shape == (N_CLIENTS,) for a in lt)
    np.testing.assert_allclose(np.stack(lt), np.stack(lj), **TOL)
    assert lt[-1].mean() < lt[0].mean()
    _assert_trees(tsess.state, jsess.state, TOL)
    assert int(tsess.state["last_trained"]) == N_CLIENTS - 1
    assert tsess.state["opt_c"]["step"].tolist() == [ROUNDS] * N_CLIENTS


def test_vanilla_meter_and_wire_report_match_reference(fitted):
    wire, sync, jsess, tsess, batches, _, _, _ = fitted
    mj, mt = jsess.meter(), tsess.meter()
    assert mt["client_gb"] == mj["client_gb"]
    for name in ("bytes_up", "bytes_down", "sync_bytes"):
        assert getattr(tsess.engine.meter, name) == getattr(
            jsess.engine.meter, name)
    # closed form: ROUNDS x (act up + grad down), plus a handoff for every
    # turn but client 0's first under p2p
    cut = 8 * HW * HW * 8
    cut = cut + 8 * HW * HW * 4 if wire != "dense" else 4 * cut
    handoff = 1212 if wire != "dense" else 4 * (216 + 8 + 576 + 8)
    h = [ROUNDS - 1] + [ROUNDS] * (N_CLIENTS - 1) if sync == "p2p" else \
        [0] * N_CLIENTS
    assert tsess.engine.meter.sync_bytes == [k * handoff for k in h]
    assert mt["client_gb"] == [(ROUNDS * 2 * cut + k * handoff) / 1e9
                               for k in h]
    if sync == "p2p":
        assert mt["client_gb"][0] < mt["client_gb"][1] == mt["client_gb"][2]
    rep_t = tsess.wire_report(batches[0][1])
    assert rep_t == jsess.wire_report(batches[0][0])
    assert [r["bytes"] for r in rep_t] == [cut, cut]
    assert all(r["physical"] == (wire == "physical") for r in rep_t)


def test_vanilla_flops_ratio_to_xla(fitted):
    _, _, jsess, tsess, _, _, _, _ = fitted
    ft, fj = tsess.meter()["client_tflops"], jsess.meter()["client_tflops"]
    assert len(set(ft)) == 1 and len(set(fj)) == 1 and fj[0] > 0
    lo, hi = FLOP_RATIO_BAND
    assert lo <= ft[0] / fj[0] <= hi, ft[0] / fj[0]


def test_vanilla_evaluate_and_leakage_match_reference(fitted):
    _, _, jsess, tsess, _, (ev_j, ev_t), _, _ = fitted
    for ci in range(N_CLIENTS):
        assert float(tsess.evaluate(ev_t, client=ci)) == float(
            jsess.evaluate(ev_j, client=ci))
    acc_t = tsess.evaluate_all(ev_t)
    assert tuple(acc_t.shape) == (N_CLIENTS,)
    np.testing.assert_array_equal(acc_t.numpy(),
                                  np.asarray(jsess.evaluate_all(ev_j)))
    for ci in range(N_CLIENTS):
        rt = tsess.leakage_report(ev_t, client=ci)
        rj = jsess.leakage_report(ev_j, client=ci)
        assert rt.keys() == rj.keys()
        for k in rj:
            np.testing.assert_allclose(rt[k], rj[k], **LEAK_TOL)


def test_vanilla_physical_wire_trains_bitwise_like_fake_wire():
    """Three rounds from one state, p2p: per-turn losses and the whole
    final state bitwise equal for the fake and physical wires."""
    _, tsess, batches, _ = _sessions("dense")
    _, tm = _models()
    runs = {}
    for name, wire in (("fake", [quantize_int8()]),
                       ("physical", [quantize_int8(physical=True)])):
        s = Plan(mode="vanilla", model=tm, cut=CUT, n_clients=N_CLIENTS,
                 optimizer=optim.adamw(1e-3), wire=wire).compile(device="cpu")
        s.state = ir.copy_tree(tsess.state)
        losses = [s.run_round(b[1]) for b in batches]
        runs[name] = (torch.stack(losses), tmod.tree_leaves(s.state))
    (lf, sf), (lp, sp_) = runs["fake"], runs["physical"]
    assert torch.equal(lf, lp)
    assert len(sf) == len(sp_) and all(torch.equal(a, b)
                                       for a, b in zip(sf, sp_))


def test_vanilla_step_program_matches_reference():
    jm, tm = _models()
    pj = jtopo.lower(jtopo.vanilla(jm, CUT))
    pt = topo.lower(topo.vanilla(tm, CUT))
    assert pt.describe() == pj.describe()
    assert pt.describe()[0] == "WeightHandoff(when='sync=p2p')"
    assert pt.round_type == pj.round_type == "turn"
    for c in range(N_CLIENTS):
        assert pt.billed_wires(c) == pj.billed_wires(c) == ("cut_act",
                                                            "cut_grad")
    assert len(pt.handoff_steps()) == len(pj.handoff_steps()) == 1


def test_vanilla_engine_state_bridges_both_ways():
    """Stacked list-of-dict client trees (pools hold `{}`), `opt_c` with
    its int32 steps and `last_trained` cross leaf for leaf, both ways."""
    jsess, tsess, batches, _ = _sessions("physical")
    _assert_trees(tsess.state, jsess.state)
    assert isinstance(tsess.state["clients"], list)
    assert tsess.state["server"][0] == {} == tsess.state["server"][2]
    assert tsess.state["opt_c"]["step"].dtype == torch.int32
    assert tuple(tsess.state["opt_c"]["step"].shape) == (N_CLIENTS,)
    assert int(tsess.state["last_trained"]) == -1
    tsess.run_round(batches[0][1])
    back = bridge.tree_from_jax(bridge.tree_to_numpy(tsess.state))
    assert jax.tree_util.tree_structure(bridge.tree_to_numpy(back)) == \
        jax.tree_util.tree_structure(_np_tree(jsess.state))
    for a, b in zip(tmod.tree_leaves(back), tmod.tree_leaves(tsess.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert back["last_trained"].dtype == torch.int32
    assert int(back["last_trained"]) == N_CLIENTS - 1


def test_identical_clients_and_unported_schedules_raise():
    _, tm = _models()
    sess = Plan(mode="vanilla", model=tm, cut=CUT,
                n_clients=N_CLIENTS).compile(device="cpu")
    st = sess.init(seed=1)
    for a in tmod.tree_leaves(st["clients"]):
        assert all(torch.equal(a[0], a[i]) for i in range(1, N_CLIENTS))
    # both schedules are ported (tests/test_torch_schedules.py);
    # microbatches need the pipelined one
    for sched, m in (("parallel", 1), ("pipelined", 2)):
        eng = Plan(mode="vanilla", model=tm, cut=CUT, n_clients=N_CLIENTS,
                   schedule=sched, microbatches=m).compile(
                       device="cpu").engine
        assert (eng.schedule, eng.microbatches) == (sched, m)
    with pytest.raises(ValueError, match="requires schedule='pipelined'"):
        Plan(mode="vanilla", model=tm, cut=CUT,
             microbatches=2).compile(device="cpu")
    # a fleet routes to the fleet engine (tests/test_torch_fleet.py)
    eng = Plan(mode="vanilla", model=tm, cut=CUT,
               fleet=FleetSpec(n_devices=1)).compile(device="cpu").engine
    assert type(eng) is FleetRoundEngine
    # an LM's SplitFns lowers to the same vanilla program
    fns = SplitFns(init=None, split=None, client_apply=None,
                   server_apply=None)
    eng = Plan(mode="vanilla", model=fns, cut=CUT).compile(
        device="cpu").engine
    assert eng.program.describe() == topo.lower(
        topo.vanilla(tm, CUT)).describe()
    with pytest.raises(ValueError, match="needs cut="):
        Plan(mode="vanilla", model=tm).compile(device="cpu")
    assert Plan(mode="vanilla", model=tm, cut=CUT,
                schedule="serial").effective_schedule == "round_robin"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Plan(mode="vanilla", model=tm, cut=CUT).compile()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_vanilla_training_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    _, tsess, batches, _ = _sessions("physical")
    _, tm = _models()
    card = Plan(mode="vanilla", model=tm, cut=CUT, n_clients=N_CLIENTS,
                optimizer=optim.adamw(1e-3),
                wire=[quantize_int8(physical=True)]).compile()
    card.state = bridge.tree_from_jax(bridge.tree_to_numpy(tsess.state),
                                      device="cuda")
    lc = [card.run_round(b[1]) for b in batches]
    lt = [tsess.run_round(b[1]) for b in batches]
    np.testing.assert_allclose(torch.stack(lc).cpu().numpy(),
                               torch.stack(lt).numpy(), rtol=1e-4, atol=1e-5)
    assert card.meter() == tsess.meter()
