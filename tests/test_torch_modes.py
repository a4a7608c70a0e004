"""The port's u-shaped, multi-hop, multi-task and extended-vanilla split
training against the JAX reference, on the CPU.

Inputs are seeded numpy arrays handed to both packages; parameters and
whole engine states come from the JAX side through `repro_torch.bridge`.
The turn kinds (u_shaped, multihop) run the smoke VGG
(`configs/vgg_cifar10.py:SMOKE`, 7 segments) over 3 clients round-robin:
u_shaped cut at (2, 6), so the client holds the two convs and FC2 with
the loss; multihop cut at [2, 4], so one relay slab (pool, conv) sits
between the data client and the server.  The branch kinds (multitask,
extended_vanilla) run the small dense branches of
`tests/test_api.py:_plan_for` over 2 modalities.  Everything is fp32 with
TF32 off.  Tolerances, each with its reason:

* wire records, wire reports, handoff bytes, metered bytes and
  `describe()`: exactly equal; the physical wire trains bitwise like the
  fake wire (the same arithmetic);
* losses, gradients, states after 3 rounds and evaluation: rtol = atol =
  1e-5 (the two frameworks sum convolutions and matmuls in different
  orders);
* leakage: rtol = atol = 1e-4, as in `tests/test_torch_train.py`;
* FLOPs: torch's counter over XLA's cost model is held to a band
  (`FLOP_RATIO_BAND`): multihop's client forward is vanilla's (two 3x3
  convs at 32 x 32) and keeps `tests/test_torch_vanilla.py`'s band; the
  dense branch's was measured here; u_shaped bills 0 in both packages.

A quantized wire rounds each crossing value to one of 255 levels, so a
value within the frameworks' fp32 difference of a rounding boundary would
round differently in the two; the seeds below put none there.

The test marked `gpu` trains on the card against the CPU and skips
without a CUDA GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.nn.layers as JL
from repro import optim as joptim
from repro.api import Plan as JPlan
from repro.api import leakage_probe as jleakage_probe
from repro.api import quantize_int8 as jquantize_int8
from repro.api import softmax_xent as jsoftmax_xent
from repro.api.wire import WireStack as JWireStack
from repro.api.wire import WireTape as JWireTape
from repro.configs import vgg_cifar10 as jvgg_cfg
from repro.core import split as jsp
from repro.engine import topology as jtopo
from repro.nn import convnets as JC
from repro_torch import bridge, optim
from repro_torch.api import (Plan, SplitFns, WireStack, WireTape,
                             leakage_probe, quantize_int8, softmax_xent)
from repro_torch.configs import vgg_cifar10 as tvgg_cfg
from repro_torch.core import split as sp
from repro_torch.engine import copy_tree
from repro_torch.engine import topology as topo
from repro_torch.nn import convnets as TC
from repro_torch.nn import layers as TL
from repro_torch.nn import module as tmod

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
LEAK_TOL = dict(rtol=1e-4, atol=1e-4)
# torch counter FLOPs / XLA cost-model FLOPs of the client forward:
# multihop's is vanilla's (tests/test_torch_vanilla.py:FLOP_RATIO_BAND);
# the dense branch's (one 64 -> 16 ReLU layer) as measured here, 0.985
FLOP_RATIO_BAND = {"multihop": (1.02, 1.03), "multitask": (0.98, 0.99),
                   "extended_vanilla": (0.98, 0.99)}
CUTS = {"u_shaped": (2, 6), "multihop": [2, 4]}
N_CLIENTS, ROUNDS, HW, N_CLS, DIM = 3, 3, 32, 4, 64


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees(t_tree, j_tree, tol=None):
    """Leafwise, with the same structure: allclose at `tol`, or bitwise
    where `tol` is None."""
    t_np = bridge.tree_to_numpy(t_tree)
    assert jax.tree_util.tree_structure(t_np) == \
        jax.tree_util.tree_structure(_np_tree(j_tree))
    for a, b in zip(jax.tree_util.tree_leaves(t_np),
                    jax.tree_util.tree_leaves(_np_tree(j_tree))):
        assert a.shape == b.shape
        if tol is None:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **tol)


def _records(wires):
    return [(w.name, tuple(w.shape), str(w.dtype).replace("torch.", ""),
             w.direction, w.bytes, w.physical) for w in wires]


WIRES = {"dense": (lambda: [], lambda: []),
         "fake": (lambda: [jquantize_int8()], lambda: [quantize_int8()]),
         "physical": (lambda: [jquantize_int8(physical=True),
                               jleakage_probe()],
                      lambda: [quantize_int8(physical=True),
                               leakage_probe()])}


def _tapes(wire):
    jw, tw = WIRES[wire]
    return (JWireTape(JWireStack(jw())) if jw() else [],
            WireTape(WireStack(tw())) if tw() else [])


# ---------------------------------------------------------------------------
# the models: smoke VGG for the turn kinds, dense branches for the others
# ---------------------------------------------------------------------------

def _models():
    cj, ct = jvgg_cfg.SMOKE, tvgg_cfg.SMOKE
    plan_j, plan_t = JC.vgg_plan(cj), TC.vgg_plan(ct)
    jm = jsp.list_segmodel(len(plan_j), lambda k: JC.vgg_init(k, cj),
                           lambda p, i, x: JC.vgg_layer_apply(p, plan_j[i], x))
    tm = sp.list_segmodel(len(plan_t), lambda g: TC.vgg_init(g, ct),
                          lambda p, i, x: TC.vgg_layer_apply(p, plan_t[i], x))
    return jm, tm


def _vgg_params(seed=4):
    """The reference's smoke VGG with non-zero biases, as (jax tree, port
    tree)."""
    pj = JC.vgg_init(jax.random.PRNGKey(seed), jvgg_cfg.SMOKE)
    pj = jax.tree_util.tree_map(lambda a: a + 0.1 if a.ndim == 1 else a, pj)
    return pj, bridge.tree_from_jax(_np_tree(pj))


def _image_batch(seed, lead):
    """{"x": lead + (HW, HW, 3), "labels": lead}: a fixed template per
    class plus 0.6 noise (`data/synthetic.py:image_batch`'s recipe)."""
    rng = np.random.default_rng(seed)
    templates = np.random.default_rng(1234).standard_normal(
        (N_CLS, HW, HW, 3))
    labels = rng.integers(0, N_CLS, lead)
    x = (templates[labels] + 0.6 * rng.standard_normal(
        lead + (HW, HW, 3))).astype(np.float32)
    return ({"x": jnp.asarray(x), "labels": jnp.asarray(labels, jnp.int32)},
            {"x": torch.from_numpy(x), "labels": torch.from_numpy(labels)})


def _modal_batch(seed, rows, per_task=False):
    """Two 64-wide modalities {"x": (2, rows, 64), "labels": (rows,)}, each
    a fixed class vector plus 0.5 noise (`multimodal_batch`'s recipe);
    per_task: labels (2, rows), task 1's being (labels + 1) % 4, as
    `tests/test_api.py:modal_batch` makes them."""
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(77).standard_normal((2, N_CLS, DIM))
    labels = rng.integers(0, N_CLS, (rows,))
    x = (w[:, labels] + 0.5 * rng.standard_normal((2, rows, DIM))
         ).astype(np.float32)
    if per_task:
        labels = np.stack([labels, (labels + 1) % N_CLS])
    return ({"x": jnp.asarray(x), "labels": jnp.asarray(labels, jnp.int32)},
            {"x": torch.from_numpy(x), "labels": torch.from_numpy(labels)})


def _dense_pair(k_in, k_out):
    """(init, apply) of one dense layer {"w": {"w", "b"}} in both
    packages, as `tests/test_api.py:_dense`."""
    return ((lambda k: {"w": JL.dense_init(k, k_in, k_out, bias=True)},
             lambda p, f: JL.dense_apply(p["w"], f)),
            (lambda g: {"w": TL.dense_init(g, k_in, k_out, bias=True)},
             lambda p, f: TL.dense_apply(p["w"], f)))


def _branches():
    """`tests/test_api.py:make_branch` (64 -> 16, ReLU) in both."""
    jb = jsp.Branch(init=lambda k: {"w": JL.dense_init(k, DIM, 16,
                                                       bias=True)},
                    apply=lambda p, x: jax.nn.relu(JL.dense_apply(p["w"], x)))
    tb = sp.Branch(init=lambda g: {"w": TL.dense_init(g, DIM, 16, bias=True)},
                   apply=lambda p, x: torch.relu(TL.dense_apply(p["w"], x)))
    return jb, tb


def _branch_params(seed=6):
    """Two branches, two heads (32 -> 4), a mid (32 -> 24) and a trunk
    (24 -> 4), non-zero biases, as (jax trees, port trees)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 6)
    dims = [(DIM, 16), (DIM, 16), (32, N_CLS), (32, N_CLS), (32, 24),
            (24, N_CLS)]
    pj = [{"w": jax.tree_util.tree_map(
        lambda a: a + 0.05 if a.ndim == 1 else a,
        JL.dense_init(k, i, o, bias=True))} for k, (i, o) in zip(keys, dims)]
    return pj, [bridge.tree_from_jax(_np_tree(p)) for p in pj]


# ---------------------------------------------------------------------------
# one step's gradients, direct
# ---------------------------------------------------------------------------

def _turn_step(kind, wire, seed=8):
    jm, tm = _models()
    pj, pt = _vgg_params()
    bj, bt = _image_batch(seed, (8,))
    tape_j, tape_t = _tapes(wire)
    if kind == "u_shaped":
        c1, c2 = CUTS[kind]
        oj = jsp.u_shaped_grads(jm, c1, c2, pj[:c1], pj[c1:c2], pj[c2:],
                                bj["x"], bj["labels"], jsoftmax_xent, tape_j)
        ot = sp.u_shaped_grads(tm, c1, c2, pt[:c1], pt[c1:c2], pt[c2:],
                               bt["x"], bt["labels"], softmax_xent, tape_t)
        return (oj[0], oj[1:4], tape_j), (ot[0], ot[1:4], tape_t)
    bounds = [0] + CUTS[kind] + [jm.n_segments]
    slabs = lambda p: [p[lo:hi] for lo, hi in zip(bounds, bounds[1:])]
    oj = jsp.multihop_grads(jm, CUTS[kind], slabs(pj), bj["x"], bj["labels"],
                            jsoftmax_xent, tape_j)
    ot = sp.multihop_grads(tm, CUTS[kind], slabs(pt), bt["x"], bt["labels"],
                           softmax_xent, tape_t)
    return (oj[0], oj[1], tape_j), (ot[0], ot[1], tape_t)


TURN_RECORDS = {
    "u_shaped": [("cut_act_1", "up", (8, HW, HW, 8)),
                 ("cut_act_2", "down", (8, 128)),
                 ("cut_grad_2", "up", (8, 128)),
                 ("cut_grad_1", "down", (8, HW, HW, 8))],
    "multihop": [("hop_0_act", "up", (8, HW, HW, 8)),
                 ("hop_1_act", "up", (8, 16, 16, 8)),
                 ("hop_1_grad", "down", (8, 16, 16, 8)),
                 ("hop_0_grad", "down", (8, HW, HW, 8))]}
GRAD_CASES = [(k, w) for k in ("u_shaped", "multihop") for w in WIRES]


@pytest.mark.parametrize("kind,wire", GRAD_CASES,
                         ids=[f"{k}-{w}" for k, w in GRAD_CASES])
def test_turn_grads_match_reference(kind, wire):
    """u_shaped: the records run cut_act_1 up, cut_act_2 down, cut_grad_2
    up, cut_grad_1 down, and no label crosses.  multihop: each hop's
    activation up, the gradients back down in reverse."""
    (lj, gj, tape_j), (lt, gt, tape_t) = _turn_step(kind, wire)
    np.testing.assert_allclose(float(lt), float(lj), **GRAD_TOL)
    _assert_trees(list(gt), list(gj), GRAD_TOL)
    recs = _records(tape_t)
    assert recs == _records(tape_j)
    assert [(r[0], r[3], r[1]) for r in recs] == TURN_RECORDS[kind]
    assert all(r[2] == "float32" and r[5] == (wire == "physical")
               for r in recs)
    for r in recs:
        n = int(np.prod(r[1]))
        assert r[4] == (4 * n if wire == "dense" else n + 4 * n // r[1][-1])


def _branch_step(kind, wire, seed=9):
    (jb, tb), (pj, pt) = _branches(), _branch_params()
    (jh, th), (jmid, tmid) = _dense_pair(32, N_CLS), _dense_pair(32, 24)
    jtr, ttr = _dense_pair(24, N_CLS)
    bj, bt = _modal_batch(seed, 16, per_task=kind == "multitask")
    tape_j, tape_t = _tapes(wire)
    xj, xt = [bj["x"][0], bj["x"][1]], [bt["x"][0], bt["x"][1]]
    if kind == "multitask":
        oj = jsp.multitask_grads([jb] * 2, pj[:2], [jh[1]] * 2, pj[2:4], xj,
                                 [bj["labels"][0], bj["labels"][1]],
                                 [jsoftmax_xent] * 2, tape_j)
        ot = sp.multitask_grads([tb] * 2, pt[:2], [th[1]] * 2, pt[2:4], xt,
                                [bt["labels"][0], bt["labels"][1]],
                                [softmax_xent] * 2, tape_t)
        return (oj[0], oj[1:3], tape_j), (ot[0], ot[1:3], tape_t)
    oj = jsp.extended_vanilla_grads([jb] * 2, pj[:2], jmid[1], pj[4],
                                    jtr[1], pj[5], xj, bj["labels"],
                                    jsoftmax_xent, tape_j)
    ot = sp.extended_vanilla_grads([tb] * 2, pt[:2], tmid[1], pt[4], ttr[1],
                                   pt[5], xt, bt["labels"], softmax_xent,
                                   tape_t)
    return (oj[0], oj[1:4], tape_j), (ot[0], ot[1:4], tape_t)


BRANCH_RECORDS = {
    "multitask": ["branch_0_act", "branch_1_act", "branch_0_grad",
                  "branch_1_grad"],
    "extended_vanilla": ["branch_0_act", "branch_1_act", "mid_act",
                         "mid_grad", "branch_0_grad", "branch_1_grad"]}
BRANCH_GRAD_CASES = [(k, w) for k in BRANCH_RECORDS for w in WIRES]


@pytest.mark.parametrize("kind,wire", BRANCH_GRAD_CASES,
                         ids=[f"{k}-{w}" for k, w in BRANCH_GRAD_CASES])
def test_branch_grads_match_reference(kind, wire):
    (lj, gj, tape_j), (lt, gt, tape_t) = _branch_step(kind, wire)
    np.testing.assert_allclose(np.asarray(lt), np.asarray(lj), **GRAD_TOL)
    _assert_trees(list(gt), list(gj), GRAD_TOL)
    assert _records(tape_t) == _records(tape_j)
    assert [r[0] for r in _records(tape_t)] == BRANCH_RECORDS[kind]
    assert all(r[5] == (wire == "physical") for r in _records(tape_t))


def test_multitask_gradients_sum_over_tasks():
    """Head t gets the gradient of ITS task's loss; each branch gets the
    sum over tasks of its cut gradient, which crosses once per branch;
    the session reports the mean over tasks.  A backward of the mean
    loss would scale every gradient by 1/T."""
    (_, tb), (_, pt) = _branches(), _branch_params()
    _, th = _dense_pair(32, N_CLS)
    _, bt = _modal_batch(10, 16, per_task=True)
    xs, labs = [bt["x"][0], bt["x"][1]], [bt["labels"][0], bt["labels"][1]]
    tape = []
    losses, g_br, g_heads, _ = sp.multitask_grads(
        [tb] * 2, pt[:2], [th[1]] * 2, pt[2:4], xs, labs,
        [softmax_xent] * 2, tape)
    assert [w.name for w in tape] == BRANCH_RECORDS["multitask"]

    def task_loss(t):
        with torch.enable_grad():
            pb = [sp._leaf_params(p) for p in pt[:2]]
            ph = sp._leaf_params(pt[2 + t])
            feats = torch.cat([tb.apply(p, x) for p, x in zip(pb, xs)], -1)
            loss = softmax_xent(th[1](ph, feats), labs[t])
            return loss, sp._grads(loss, (pb, ph))

    (l0, (gb0, gh0)), (l1, (gb1, gh1)) = task_loss(0), task_loss(1)
    assert torch.allclose(losses, torch.stack([l0, l1]).detach())
    for own, alone in ((g_heads[0], gh0), (g_heads[1], gh1)):
        for a, b in zip(tmod.tree_leaves(own), tmod.tree_leaves(alone)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    summed = [tmod.tree_map(torch.add, a, b) for a, b in zip(gb0, gb1)]
    for a, b in zip(tmod.tree_leaves(g_br), tmod.tree_leaves(summed)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # the mean's backward is half the sum: not what the branches get
    halves = [tmod.tree_map(lambda g: g / 2, s) for s in summed]
    assert not all(torch.allclose(a, b) for a, b in zip(
        tmod.tree_leaves(g_br), tmod.tree_leaves(halves)))
    (jb, _), (pj, _) = _branches(), _branch_params()
    jh, _ = _dense_pair(32, N_CLS)
    bj, _ = _modal_batch(10, 16, per_task=True)
    sess_j = JPlan(mode="multitask", branch=jb, heads=(jh, jh),
                   n_clients=2).compile()
    sess_t = Plan(mode="multitask", branch=tb, heads=(th, th),
                  n_clients=2).compile(device="cpu")
    sess_j.init(jax.random.PRNGKey(1))
    sess_t.state = bridge.tree_from_jax(_np_tree(sess_j.state))
    st = copy_tree(sess_t.state)
    lt = sess_t.run_round(bt)
    np.testing.assert_allclose(lt.numpy(), np.asarray(sess_j.run_round(bj)),
                               **TOL)
    want, _, _ = sess_t.engine.topology.round_grads(
        st["clients"], st["server"], bt, softmax_xent)
    assert tuple(lt.shape) == (1,) and float(lt[0]) == float(want)


def test_multihop_relay_crossings_are_unbilled():
    """The relay hop crosses the wire (a physical, int8 record) but is
    billed to no data client; the client pays for hop 0 both ways."""
    _, tm = _models()
    prog = topo.lower(topo.multihop(tm, CUTS["multihop"]))
    for c in range(N_CLIENTS):
        assert prog.billed_wires(c) == ("hop_0_act", "hop_0_grad")
    relay = [s for s in prog.wire_steps() if s.owner == "server"]
    assert [s.name for s in relay] == ["hop_1_act", "hop_1_grad"]
    _, (_, _, tape) = _turn_step("multihop", "physical")
    assert [w.name for w in tape if w.physical] == [
        "hop_0_act", "hop_1_act", "hop_1_grad", "hop_0_grad"]


# ---------------------------------------------------------------------------
# Plan(mode=...) end to end
# ---------------------------------------------------------------------------

def _plans(kind, wire, sync="p2p", lr=1e-3):
    jw, tw = WIRES[wire]
    common = dict(n_clients=N_CLIENTS if kind in CUTS else 2, sync=sync)
    if kind in CUTS:
        jm, tm = _models()
        jkw, tkw = dict(model=jm, cuts=CUTS[kind]), dict(model=tm,
                                                         cuts=CUTS[kind])
    else:
        (jb, tb) = _branches()
        (jh, th), (jmid, tmid) = _dense_pair(32, N_CLS), _dense_pair(32, 24)
        jtr, ttr = _dense_pair(24, N_CLS)
        jkw, tkw = ((dict(branch=jb, heads=(jh, jh)),
                     dict(branch=tb, heads=(th, th)))
                    if kind == "multitask" else
                    (dict(branch=jb, mid=jmid, trunk=jtr),
                     dict(branch=tb, mid=tmid, trunk=ttr)))
    jplan = JPlan(mode=kind, optimizer=joptim.adamw(lr), wire=jw(),
                  **common, **jkw)
    tplan = Plan(mode=kind, optimizer=optim.adamw(lr), wire=tw(), **common,
                 **tkw)
    return jplan, tplan


def _round_batches(kind):
    """ROUNDS rounds of batches and a 64-row evaluation batch (the
    distance correlation needs tens of rows for 1e-4)."""
    if kind in CUTS:
        return ([_image_batch(100 + r, (N_CLIENTS, 8)) for r in range(ROUNDS)],
                _image_batch(100 + ROUNDS, (64,)))
    per_task = kind == "multitask"
    return ([_modal_batch(200 + r, 16, per_task) for r in range(ROUNDS)],
            _modal_batch(200 + ROUNDS, 64, per_task))


FIT_CASES = [("u_shaped", "physical", "p2p"), ("u_shaped", "fake", "none"),
             ("multihop", "physical", "p2p"), ("multihop", "dense", "none"),
             ("multitask", "physical", "p2p"),
             ("extended_vanilla", "physical", "p2p")]


@pytest.fixture(scope="module", params=FIT_CASES,
                ids=[f"{k}-{w}-{s}" for k, w, s in FIT_CASES])
def fitted(request):
    kind, wire, sync = request.param
    jplan, tplan = _plans(kind, wire, sync)
    jsess = jplan.compile()
    jsess.init(jax.random.PRNGKey(0))
    tsess = tplan.compile(device="cpu")
    tsess.state = bridge.tree_from_jax(_np_tree(jsess.state))
    batches, ev = _round_batches(kind)
    lj = [np.asarray(jsess.run_round(b[0])) for b in batches]
    lt = [tsess.run_round(b[1]).numpy() for b in batches]
    return kind, wire, sync, jsess, tsess, batches, ev, lj, lt


def test_fit_losses_and_state_match_reference(fitted):
    kind, _, _, jsess, tsess, _, _, lj, lt = fitted
    np.testing.assert_allclose(np.stack(lt), np.stack(lj), **TOL)
    assert lt[-1].mean() < lt[0].mean()
    _assert_trees(tsess.state, jsess.state, TOL)
    if kind == "multihop":      # the server is a tuple of relay slabs
        assert isinstance(tsess.state["server"], tuple)
    if kind == "multitask":     # the heads are a tuple
        assert isinstance(tsess.state["server"], tuple)
        assert len(tsess.state["server"]) == 2
    if kind == "u_shaped":
        assert set(tsess.state["clients"]) == {"head", "tail"}


def test_meter_and_wire_report_match_reference(fitted):
    kind, wire, sync, jsess, tsess, batches, _, _, _ = fitted
    mj, mt = jsess.meter(), tsess.meter()
    assert mt["client_gb"] == mj["client_gb"]
    for name in ("bytes_up", "bytes_down", "sync_bytes"):
        assert getattr(tsess.engine.meter, name) == getattr(
            jsess.engine.meter, name)
    rep_t = tsess.wire_report(batches[0][1])
    rep_j = jsess.wire_report(batches[0][0])
    assert rep_t == rep_j
    assert all(r["physical"] == (wire == "physical") for r in rep_t)
    billed = {r["name"]: r["bytes"] for r in rep_t}
    prog, meter = tsess.engine.program, tsess.engine.meter
    for c in range(len(meter.bytes_up)):
        assert meter.bytes_up[c] + meter.bytes_down[c] == ROUNDS * sum(
            billed[n] for n in prog.billed_wires(c))
    names = {n for c in range(len(meter.bytes_up))
             for n in prog.billed_wires(c)}
    if kind == "u_shaped":      # every crossing is the client's
        assert set(names) == set(billed)
    if kind in ("multihop", "extended_vanilla"):
        assert set(billed) - set(names) == ({"hop_1_act", "hop_1_grad"}
                                            if kind == "multihop" else
                                            {"mid_act", "mid_grad"})
    if kind in CUTS:
        sync_bytes = tsess.engine.meter.sync_bytes
        if sync == "p2p":       # the handoff squeezes the whole client
            h = tsess.wire_stack.handoff_bytes(
                tmod.tree_map(lambda a: a[0], tsess.state["clients"])) \
                if tsess.wire_stack.has_handoff else None
            assert sync_bytes[0] < sync_bytes[1] == sync_bytes[2]
            if h is not None:
                assert sync_bytes[1] == ROUNDS * h
        else:
            assert sync_bytes == [0] * N_CLIENTS


def test_u_shaped_handoff_squeezes_head_and_tail():
    """The client tree is {"head", "tail"}: the handoff prices and
    squeezes every leaf of both, as the reference does."""
    jplan, tplan = _plans("u_shaped", "physical")
    jsess, tsess = jplan.compile(), tplan.compile(device="cpu")
    jsess.init(jax.random.PRNGKey(2))
    tsess.state = bridge.tree_from_jax(_np_tree(jsess.state))
    pj = jax.tree_util.tree_map(lambda a: a[0], jsess.state["clients"])
    pt = tmod.tree_map(lambda a: a[0], tsess.state["clients"])
    # conv 1 (3,3,3,8), conv 2 (3,3,8,8), FC2 (128,4) and their biases
    want = (27 * 8 + 27 * 4 + 8 + 4) + (72 * 8 + 72 * 4 + 8 + 4) + (
        128 * 4 + 128 * 4 + 4 + 4)
    assert tsess.wire_stack.handoff_bytes(pt) == \
        jsess.wire_stack.handoff_bytes(pj) == want
    _assert_trees(tsess.wire_stack.handoff_recv(pt),
                  jsess.wire_stack.handoff_recv(pj))
    assert len(tmod.tree_leaves(pt["tail"])) == 2


def test_flops_match_reference(fitted):
    kind, _, _, jsess, tsess, _, _, _, _ = fitted
    ft, fj = tsess.meter()["client_tflops"], jsess.meter()["client_tflops"]
    if kind == "u_shaped":      # client_fwd=None: 0 billed in both
        assert ft == fj == [0.0] * N_CLIENTS
        return
    assert len(set(ft)) == 1 and fj[0] > 0
    lo, hi = FLOP_RATIO_BAND[kind]
    assert lo <= ft[0] / fj[0] <= hi, ft[0] / fj[0]


def test_evaluate_and_leakage_match_reference(fitted):
    kind, _, _, jsess, tsess, _, (ev_j, ev_t), _, _ = fitted
    assert float(tsess.evaluate(ev_t)) == float(jsess.evaluate(ev_j))
    acc_t = tsess.evaluate_all(ev_t)
    np.testing.assert_array_equal(acc_t.numpy(),
                                  np.asarray(jsess.evaluate_all(ev_j)))
    assert tuple(acc_t.shape) == ((N_CLIENTS,) if kind in CUTS else (1,))
    if kind == "u_shaped":      # no client forward to probe
        for sess, ev in ((tsess, ev_t), (jsess, ev_j)):
            with pytest.raises(ValueError, match="client forward"):
                sess.leakage_report(ev)
        return
    if kind == "multitask":     # the label dcor takes one task's labels
        ev_t = {**ev_t, "labels": ev_t["labels"][0]}
        ev_j = {**ev_j, "labels": ev_j["labels"][0]}
    rt, rj = tsess.leakage_report(ev_t), jsess.leakage_report(ev_j)
    assert rt.keys() == rj.keys()
    for k in rj:
        np.testing.assert_allclose(rt[k], rj[k], **LEAK_TOL)


KINDS = ("u_shaped", "multihop", "multitask", "extended_vanilla")


@pytest.mark.parametrize("kind", KINDS)
def test_physical_wire_trains_bitwise_like_fake_wire(kind):
    """Three rounds from one state: losses and the whole final state
    bitwise equal for the fake and the physical wire."""
    jplan, _ = _plans(kind, "dense")
    jsess = jplan.compile()
    jsess.init(jax.random.PRNGKey(3))
    state = bridge.tree_from_jax(_np_tree(jsess.state))
    batches, _ = _round_batches(kind)
    runs = {}
    for wire in ("fake", "physical"):
        s = _plans(kind, wire)[1].compile(device="cpu")
        s.state = copy_tree(state)
        runs[wire] = (torch.stack([s.run_round(b[1]) for b in batches]),
                      tmod.tree_leaves(s.state))
    (lf, sf), (lp, sp_) = runs["fake"], runs["physical"]
    assert torch.equal(lf, lp)
    assert len(sf) == len(sp_) and all(torch.equal(a, b)
                                       for a, b in zip(sf, sp_))


@pytest.mark.parametrize("kind", KINDS)
def test_step_program_matches_reference(kind):
    jm, tm = _models()
    (jb, tb), ((jh, th), (jmid, tmid)) = _branches(), (
        _dense_pair(32, N_CLS), _dense_pair(32, 24))
    if kind == "u_shaped":
        pj = jtopo.lower(jtopo.u_shaped(jm, *CUTS[kind]))
        pt = topo.lower(topo.u_shaped(tm, *CUTS[kind]))
    elif kind == "multihop":
        pj = jtopo.lower(jtopo.multihop(jm, [1, 3, 5]))
        pt = topo.lower(topo.multihop(tm, [1, 3, 5]))
    elif kind == "multitask":
        pj = jtopo.lower(jtopo.multitask(jb, 2, [jh[0]] * 3, [jh[1]] * 3))
        pt = topo.lower(topo.multitask(tb, 2, [th[0]] * 3, [th[1]] * 3))
    else:
        pj = jtopo.lower(jtopo.extended_vanilla(jb, 2, *jmid, *jh))
        pt = topo.lower(topo.extended_vanilla(tb, 2, *tmid, *th))
    assert pt.describe() == pj.describe()
    assert pt.round_type == pj.round_type
    assert pt.kind == pj.kind == kind
    for c in range(N_CLIENTS):
        assert pt.billed_wires(c) == pj.billed_wires(c)
    assert len(pt.handoff_steps()) == len(pj.handoff_steps())


def test_engine_states_bridge_both_ways():
    """Tuples stay tuples (the multihop server, the multitask heads) and
    the u-shaped {"head", "tail"} client tree crosses leaf for leaf."""
    for kind in ("multihop", "multitask", "u_shaped"):
        jplan, tplan = _plans(kind, "physical")
        jsess = jplan.compile()
        jsess.init(jax.random.PRNGKey(4))
        st = bridge.tree_from_jax(_np_tree(jsess.state))
        _assert_trees(st, jsess.state)
        back = bridge.tree_from_jax(bridge.tree_to_numpy(st))
        for a, b in zip(tmod.tree_leaves(back), tmod.tree_leaves(st)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        if kind != "u_shaped":
            assert isinstance(back["server"], tuple)
            assert isinstance(back["opt_s"]["m"], tuple)


def test_unported_schedules_and_models_raise():
    _, tm = _models()
    for kind in ("u_shaped", "multihop"):
        # both schedules are ported (tests/test_torch_schedules.py);
        # microbatches need the pipelined one
        for sched in ("parallel", "pipelined"):
            eng = Plan(mode=kind, model=tm, cuts=CUTS[kind], n_clients=2,
                       schedule=sched).compile(device="cpu").engine
            assert eng.schedule == sched
        with pytest.raises(ValueError,
                           match="requires schedule='pipelined'"):
            Plan(mode=kind, model=tm, cuts=CUTS[kind],
                 microbatches=2).compile(device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Plan(mode=kind, model=tm, cuts=CUTS[kind],
                 fleet=object()).compile(device="cpu")
        # SplitFns trains vanilla only, as in the reference
        fns = SplitFns(init=None, split=None, client_apply=None,
                       server_apply=None)
        with pytest.raises(ValueError, match="needs model= \\(SegModel\\)"):
            Plan(mode=kind, model=fns, cuts=CUTS[kind]).compile(device="cpu")
    with pytest.raises(ValueError, match="needs cuts="):
        Plan(mode="u_shaped", model=tm, cuts=(2,)).compile(device="cpu")
    _, tb = _branches()
    with pytest.raises(ValueError, match="needs heads="):
        Plan(mode="multitask", branch=tb).compile(device="cpu")
    with pytest.raises(ValueError, match="needs mid="):
        Plan(mode="extended_vanilla", branch=tb).compile(device="cpu")
    heads = (_dense_pair(32, 4)[1],)
    eng = Plan(mode="multitask", branch=tb, heads=heads, schedule="pipelined",
               microbatches=2).compile(device="cpu").engine
    assert (eng.schedule, eng.microbatches) == ("pipelined", 2)
    with pytest.raises(ValueError, match="single-mesh"):
        Plan(mode="multitask", branch=tb, heads=heads, schedule="pipelined",
             microbatches=2, fleet=object()).compile(device="cpu")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_modes_training_on_card_match_cpu():
    """u_shaped and multitask over the physical wire: 3 rounds on the card
    (the wire kernels) against the CPU (their plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    for kind in ("u_shaped", "multitask"):
        jplan, tplan = _plans(kind, "physical")
        jsess = jplan.compile()
        jsess.init(jax.random.PRNGKey(5))
        on_cpu = tplan.compile(device="cpu")
        on_card = tplan.compile()
        on_cpu.state = bridge.tree_from_jax(_np_tree(jsess.state))
        on_card.state = bridge.tree_from_jax(_np_tree(jsess.state),
                                             device="cuda")
        batches, _ = _round_batches(kind)
        lc = torch.stack([on_card.run_round(b[1]) for b in batches])
        lt = torch.stack([on_cpu.run_round(b[1]) for b in batches])
        np.testing.assert_allclose(lc.cpu().numpy(), lt.numpy(), rtol=1e-4,
                                   atol=1e-5)
        assert on_card.meter() == on_cpu.meter()
