"""The port's parallel (SplitFed) and microbatch-pipelined schedules
against the JAX reference, on the CPU.

Inputs are seeded numpy arrays handed to both packages; parameters and
whole engine states come from the JAX side through `repro_torch.bridge`.
The models, batches and wires are `tests/test_torch_modes.py`'s: the turn
kinds and the baselines run the smoke VGG (`configs/vgg_cifar10.py:
SMOKE`, 7 segments) over 3 clients of 8 rows (vanilla cut 2, u_shaped
(2, 6), multihop [2, 4], fedavg 2 local steps); the branch kinds run the
small dense branches over 2 modalities of 16 rows.  Everything is fp32
with TF32 off, AdamW at the `Plan` default of 1e-3, except fedavg, which
runs SGD with momentum 0.9 at 0.05: under AdamW its 2 local steps a
round drive 3 of conv 1's 216 weights a whole Adam step (1e-3) apart
across the frameworks within 3 rounds, on these batches at M=1 as at
M=2 and on the physical wire too, where Adam divides two moments whose
gradients nearly cancel (`tests/test_torch_baselines.py` found the same
on its dense wire).  Tolerances, each with its reason:

* `split_turn_batch`, `split_branch_batch` and `microbatch_mean` (over
  integer-valued data, so every sum is exact): bitwise;
* wire records, packed payloads given the same dense value, metered
  bytes: exactly equal; the physical wire trains bitwise like the fake
  wire, the pipelined meter is the round-robin meter exactly, and the
  pipelined schedule at M=1 is the round-robin bitwise (the same
  arithmetic);
* one staged turn's gradients: `GRAD_TOL`, states and losses after 3
  rounds: `TOL`, as in `tests/test_torch_modes.py` (the two frameworks sum
  convolutions and matmuls in different orders).  The pipelined schedule
  is held to the reference at the SAME M, so the tolerance stays the
  port's usual one; every case runs the physical wire, where the
  dense-wire fedavg drift that `tests/test_torch_baselines.py` documents
  does not arise.

The tests marked `gpu` train on the card against the CPU and skip without
a CUDA GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_modes import (CUTS, WIRES, _assert_trees, _branches,
                              _dense_pair, _image_batch, _modal_batch,
                              _models, _np_tree, _records, _vgg_params)

from repro import optim as joptim
from repro.api import Plan as JPlan
from repro.api import FleetSpec as JFleetSpec
from repro.api import softmax_xent as jsoftmax_xent
from repro.api.wire import WireStack as JWireStack
from repro.api.wire import WireTape as JWireTape
from repro.api.wire import with_wire as jwith_wire
from repro.engine import program as jprog
from repro.engine import topology as jtopo
from repro_torch import bridge, optim
from repro_torch.api import (Plan, WireStack, WireTape, lm_split_fns,
                             softmax_xent, with_wire)
from repro_torch.configs import get_config
from repro_torch.core import wire_compress as twc
from repro_torch.engine import copy_tree
from repro_torch.engine import program as prog
from repro_torch.engine import topology as topo
from repro_torch.models import build_model
from repro_torch.nn import module as tmod

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
N_CLIENTS, ROUNDS, N_CLS = 3, 3, 4
TURN_KINDS = ("vanilla", "u_shaped", "multihop")
BRANCH_KINDS = ("vertical", "multitask", "extended_vanilla")
MODES = TURN_KINDS + BRANCH_KINDS + ("fedavg", "large_batch")
TURN_CUTS = {"vanilla": {"cut": 2}, "u_shaped": {"cuts": CUTS["u_shaped"]},
             "multihop": {"cuts": CUTS["multihop"]}}


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# microbatch splitting
# ---------------------------------------------------------------------------

def _int_valued(seed, shape):
    return np.random.default_rng(seed).integers(-50, 50, shape).astype(
        np.float32)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_split_turn_batch_and_microbatch_mean_match_reference(m):
    x, lab = _int_valued(0, (8, 5, 3)), np.arange(8)
    bj = {"x": jnp.asarray(x), "labels": jnp.asarray(lab)}
    bt = {"x": torch.from_numpy(x), "labels": torch.from_numpy(lab)}
    sj, st = jprog.split_turn_batch(bj, m), prog.split_turn_batch(bt, m)
    assert tuple(st["x"].shape) == (m, 8 // m, 5, 3)
    _assert_trees(st, sj)
    fj = lambda mb: (mb["x"].sum(), {"g": mb["x"] * 3.0,
                                     "l": mb["labels"].astype(jnp.float32)})
    ft = lambda mb: (mb["x"].sum(), {"g": mb["x"] * 3.0,
                                     "l": mb["labels"].float()})
    _assert_trees(prog.microbatch_mean(ft, bt, m),
                  jprog.microbatch_mean(fj, bj, m))
    for split, batch in ((jprog.split_turn_batch, bj),
                         (prog.split_turn_batch, bt)):
        with pytest.raises(ValueError, match="must divide evenly into "
                                             "microbatches=3"):
            split(batch, 3)


@pytest.mark.parametrize("per_task", [False, True], ids=["shared", "tasks"])
def test_split_branch_batch_matches_reference(per_task):
    """{"x": (K, B, ...), "labels": (B,) or (T, B)} -> the same layout per
    microbatch on a leading M axis; `microbatch_mean` over it."""
    x = _int_valued(1, (2, 8, 6))
    lab = np.arange(16).reshape(2, 8) if per_task else np.arange(8)
    bj = {"x": jnp.asarray(x), "labels": jnp.asarray(lab)}
    bt = {"x": torch.from_numpy(x), "labels": torch.from_numpy(lab)}
    for m in (1, 2, 4):
        st = prog.split_branch_batch(bt, m)
        _assert_trees(st, jprog.split_branch_batch(bj, m))
        assert tuple(st["x"].shape) == (m, 2, 8 // m, 6)
        assert tuple(st["labels"].shape) == ((m, 2, 8 // m) if per_task
                                             else (m, 8 // m))
        _assert_trees(
            prog.microbatch_mean(lambda mb: mb["x"] * 2.0, bt, m,
                                 prog.split_branch_batch),
            jprog.microbatch_mean(lambda mb: mb["x"] * 2.0, bj, m,
                                  jprog.split_branch_batch))
    for split, batch in ((jprog.split_branch_batch, bj),
                         (prog.split_branch_batch, bt)):
        with pytest.raises(ValueError, match="must divide evenly"):
            split(batch, 3)


# ---------------------------------------------------------------------------
# the staged turn: pipeline_fwd / rest / bwd
# ---------------------------------------------------------------------------

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


def _turn_topologies(kind):
    jm, tm = _models()
    if kind == "vanilla":
        return jtopo.vanilla(jm, 2), topo.vanilla(tm, 2)
    if kind == "u_shaped":
        return (jtopo.u_shaped(jm, *CUTS[kind]),
                topo.u_shaped(tm, *CUTS[kind]))
    return jtopo.multihop(jm, CUTS[kind]), topo.multihop(tm, CUTS[kind])


def _turn_sides(kind, p):
    """(client, server) trees of kind `kind` sliced from full params."""
    if kind == "vanilla":
        return p[:2], p[2:]
    if kind == "u_shaped":
        c1, c2 = CUTS[kind]
        return {"head": p[:c1], "tail": p[c2:]}, p[c1:c2]
    c0, c1 = CUTS[kind]
    return p[:c0], (p[c0:c1], p[c1:])


STAGE_RECORDS = {"vanilla": ["cut_act", "cut_grad"],
                 "u_shaped": ["cut_act_1", "cut_act_2", "cut_grad_2",
                              "cut_grad_1"],
                 "multihop": ["hop_0_act", "hop_1_act", "hop_1_grad",
                              "hop_0_grad"]}
STAGE_CASES = [(k, w) for k in TURN_KINDS for w in WIRES]


@pytest.mark.parametrize("kind,wire", STAGE_CASES,
                         ids=[f"{k}-{w}" for k, w in STAGE_CASES])
def test_pipeline_stages_match_reference(kind, wire):
    """One staged turn, stage by stage: the client forward, the rest
    (records and, on the physical wire, the packed payloads), the
    rematerialized client backward; then the whole two-microbatch
    `_pipelined_turn` through the wire-wrapped topology."""
    tj, tt = _turn_topologies(kind)
    (pcj, psj), (pct, pst) = [_turn_sides(kind, p) for p in _vgg_params()]
    bj, bt = _image_batch(8, (8,))
    act_j, act_t = tj.pipeline_fwd(pcj, bj), tt.pipeline_fwd(pct, bt)
    np.testing.assert_allclose(act_t.numpy(), np.asarray(act_j), **GRAD_TOL)
    jw, tw = WIRES[wire]
    tape_j = _CaptureJ(JWireStack(jw())) if jw() else []
    tape_t = _CaptureT(WireStack(tw())) if tw() else []
    out_j = tj.pipeline_rest(pcj, psj, act_j, bj, jsoftmax_xent, tape_j)
    out_t = tt.pipeline_rest(pct, pst, act_t, bt, softmax_xent, tape_t)
    np.testing.assert_allclose(float(out_t[0]), float(out_j[0]), **GRAD_TOL)
    _assert_trees(list(out_t[1:]), list(out_j[1:]), GRAD_TOL)
    assert _records(tape_t) == _records(tape_j)
    assert [r[0] for r in _records(tape_t)] == STAGE_RECORDS[kind]
    assert all(r[5] == (wire == "physical") for r in _records(tape_t))
    if wire == "physical":      # what the reference packs, the port packs
        for (nj, dj, pj), (nt, _, pt) in zip(tape_j.values, tape_t.values,
                                             strict=True):
            own = twc.pack_int8(torch.from_numpy(np.array(dj)))
            assert nj == nt
            np.testing.assert_array_equal(own.q.numpy(), np.asarray(pj.q))
            np.testing.assert_array_equal(own.scale.numpy(),
                                          np.asarray(pj.scale))
            assert tuple(pt.q.shape) == tuple(pj.q.shape)
    g_cj = tj.pipeline_bwd(pcj, bj, out_j[3], out_j[1])
    g_ct = tt.pipeline_bwd(pct, bt, out_t[3], out_t[1])
    _assert_trees(g_ct, g_cj, GRAD_TOL)
    if kind == "u_shaped":      # the head's remat joined with the tail's
        assert set(g_ct) == {"head", "tail"}
        assert all(torch.equal(a, b) for a, b in zip(
            tmod.tree_leaves(g_ct["tail"]),
            tmod.tree_leaves(out_t[1]["tail"]), strict=True))
    # the two-microbatch turn, through the wire middleware
    tj = jwith_wire(tj, JWireStack(jw()))
    tt = with_wire(tt, WireStack(tw()))
    lj, gcj, gsj = jprog._pipelined_turn(tj, jsoftmax_xent, pcj, psj, bj, 2,
                                         jprog.split_turn_batch)
    lt, gct, gst = prog._pipelined_turn(tt, softmax_xent, pct, pst, bt, 2,
                                        prog.split_turn_batch)
    np.testing.assert_allclose(float(lt), float(lj), **GRAD_TOL)
    _assert_trees(gct, gcj, GRAD_TOL)
    _assert_trees(gst, gsj, GRAD_TOL)


@pytest.mark.parametrize("kind", TURN_KINDS)
def test_one_microbatch_is_the_serial_turn_bitwise(kind):
    """M=1 is exactly fwd -> rest -> bwd: the serial turn's values."""
    _, tt = _turn_topologies(kind)
    tt = with_wire(tt, WireStack(WIRES["physical"][1]()))
    pc, ps = _turn_sides(kind, _vgg_params()[1])
    _, bt = _image_batch(9, (8,))
    staged = prog._pipelined_turn(tt, softmax_xent, pc, ps, bt, 1,
                                  prog.split_turn_batch)
    serial = tt.turn_grads(pc, ps, bt, softmax_xent)
    for a, b in zip(tmod.tree_leaves(staged), tmod.tree_leaves(serial),
                    strict=True):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Plan(schedule=...) end to end
# ---------------------------------------------------------------------------

def _plans(mode, wire="physical", **over):
    jw, tw = WIRES[wire]
    common = dict(n_clients=2 if mode in BRANCH_KINDS else N_CLIENTS, **over)
    if mode in BRANCH_KINDS:
        (jb, tb), (jh, th) = _branches(), _dense_pair(32, N_CLS)
        (jmid, tmid), (jtr, ttr) = _dense_pair(32, 24), _dense_pair(24, N_CLS)
        jkw, tkw = {"vertical": (dict(trunk=jh), dict(trunk=th)),
                    "multitask": (dict(heads=(jh, jh)), dict(heads=(th, th))),
                    "extended_vanilla": (dict(mid=jmid, trunk=jtr),
                                         dict(mid=tmid, trunk=ttr))}[mode]
        jkw, tkw = dict(branch=jb, **jkw), dict(branch=tb, **tkw)
    else:
        jm, tm = _models()
        cuts = TURN_CUTS.get(mode, {"local_steps": 2} if mode == "fedavg"
                             else {})
        jkw, tkw = dict(model=jm, **cuts), dict(model=tm, **cuts)
    jopt, topt = ((joptim.sgd(0.05, 0.9), optim.sgd(0.05, 0.9))
                  if mode == "fedavg" else
                  (joptim.adamw(1e-3), optim.adamw(1e-3)))
    return (JPlan(mode=mode, optimizer=jopt, wire=jw(), **common, **jkw),
            Plan(mode=mode, optimizer=topt, wire=tw(), **common, **tkw))


def _round_batches(mode):
    if mode in BRANCH_KINDS:
        return [_modal_batch(200 + r, 16, mode == "multitask")
                for r in range(ROUNDS)]
    return [_image_batch(100 + r, (N_CLIENTS, 8)) for r in range(ROUNDS)]


def _fit(mode, wire="physical", seed=0, **over):
    """Both packages from the reference's init, ROUNDS rounds: (jax
    session, port session, [jax losses], [port losses])."""
    jplan, tplan = _plans(mode, wire, **over)
    jsess = jplan.compile()
    jsess.init(jax.random.PRNGKey(seed))
    tsess = tplan.compile(device="cpu")
    tsess.state = bridge.tree_from_jax(_np_tree(jsess.state))
    batches = _round_batches(mode)
    lj = [np.asarray(jsess.run_round(b[0])) for b in batches]
    lt = [tsess.run_round(b[1]).numpy() for b in batches]
    return jsess, tsess, lj, lt


def _port_fit(mode, state=None, wire="physical", **over):
    """The port alone from `state` (None: a fresh init): (session, losses
    (ROUNDS, ...))."""
    sess = _plans(mode, wire, **over)[1].compile(device="cpu")
    if state is None:
        sess.init(seed=0)
    else:
        sess.state = copy_tree(state)
    return sess, torch.stack([sess.run_round(b[1])
                              for b in _round_batches(mode)])


def _state_of(jsess):
    """The reference session's state on the port."""
    return bridge.tree_from_jax(_np_tree(jsess.state))


def _wire_meter(sess):
    """The metered bytes, exact across the packages (the FLOPs come from
    two counters, held to a band in `tests/test_torch_vanilla.py`)."""
    m = sess.engine.meter
    return m.bytes_up, m.bytes_down, m.sync_bytes


def _meter(sess):
    return (sess.engine.meter.flops,) + _wire_meter(sess)


PARALLEL_CASES = [("vanilla", "physical"), ("vanilla", "dense"),
                  ("u_shaped", "physical"), ("u_shaped", "fake"),
                  ("multihop", "physical")]


@pytest.fixture(scope="module", params=PARALLEL_CASES,
                ids=[f"{k}-{w}" for k, w in PARALLEL_CASES])
def parallel(request):
    kind, wire = request.param
    return (kind, wire) + _fit(kind, wire, schedule="parallel")


def test_parallel_fit_matches_reference(parallel):
    """SplitFed: per-client losses (N,), the state after ROUNDS rounds,
    `last_trained` left at -1, and the clients apart (no handoff)."""
    kind, _, jsess, tsess, lj, lt = parallel
    assert all(a.shape == (N_CLIENTS,) for a in lt)
    np.testing.assert_allclose(np.stack(lt), np.stack(lj), **TOL)
    _assert_trees(tsess.state, jsess.state, TOL)
    assert int(tsess.state["last_trained"]) == -1
    assert lt[-1].mean() < lt[0].mean()
    leaves = tmod.tree_leaves(tsess.state["clients"])
    assert any(not torch.equal(a[0], a[1]) for a in leaves)
    assert tsess.engine.program.round_type == "turn"


def test_parallel_meter_matches_reference(parallel):
    """Each client is billed a serial turn's cut bytes a round, and no
    handoff."""
    kind, wire, jsess, tsess, _, _ = parallel
    assert _wire_meter(tsess) == _wire_meter(jsess)
    assert tsess.engine.meter.sync_bytes == [0] * N_CLIENTS
    serial, _ = _port_fit(kind, wire=wire)
    assert tsess.engine.meter.bytes_up == serial.engine.meter.bytes_up
    assert tsess.engine.meter.bytes_down == serial.engine.meter.bytes_down
    assert tsess.meter()["client_tflops"] == serial.meter()["client_tflops"]


PIPELINED_CASES = [(mode, m) for mode in MODES for m in (1, 2)]


@pytest.fixture(scope="module", params=PIPELINED_CASES,
                ids=[f"{mode}-M{m}" for mode, m in PIPELINED_CASES])
def pipelined(request):
    mode, m = request.param
    return (mode, m) + _fit(mode, schedule="pipelined", microbatches=m)


def test_pipelined_fit_matches_reference(pipelined):
    mode, m, jsess, tsess, lj, lt = pipelined
    np.testing.assert_allclose(np.stack(lt), np.stack(lj), **TOL)
    _assert_trees(tsess.state, jsess.state, TOL)
    if mode in TURN_KINDS:
        assert lt[0].shape == (N_CLIENTS,)
        assert int(tsess.state["last_trained"]) == N_CLIENTS - 1
    elif mode in BRANCH_KINDS:
        assert lt[0].shape == (1,)
    assert tsess.engine.microbatches == m


def test_pipelined_meter_matches_reference_and_default_schedule(pipelined):
    """Wire bytes do not depend on the microbatch count, and the handoff
    is still billed once a turn: the meter is the reference's and the
    mode's default schedule's, exactly."""
    mode, m, jsess, tsess, _, _ = pipelined
    assert _wire_meter(tsess) == _wire_meter(jsess)
    default, _ = _port_fit(mode)
    assert _meter(tsess) == _meter(default)
    if mode in TURN_KINDS:
        sync = tsess.engine.meter.sync_bytes
        assert 0 < sync[0] < sync[1] == sync[2]


EQUAL_CASES = ([(mode, "pipelined") for mode in MODES]
               + [(kind, "parallel") for kind in TURN_KINDS])


@pytest.mark.parametrize("mode,schedule", EQUAL_CASES,
                         ids=[f"{m}-{s}" for m, s in EQUAL_CASES])
def test_physical_wire_trains_bitwise_like_fake_wire(mode, schedule):
    """Three rounds from one state, two microbatches under the pipelined
    schedule: losses and the whole final state bitwise equal for the
    fake and the physical wire."""
    over = dict(schedule=schedule,
                microbatches=2 if schedule == "pipelined" else 1)
    jsess = _plans(mode, "dense")[0].compile()
    jsess.init(jax.random.PRNGKey(3))
    state = _state_of(jsess)
    sf, lf = _port_fit(mode, state, "fake", **over)
    sp_, lp = _port_fit(mode, state, "physical", **over)
    assert torch.equal(lf, lp)
    for a, b in zip(tmod.tree_leaves(sf.state), tmod.tree_leaves(sp_.state),
                    strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", TURN_KINDS)
def test_pipelined_one_microbatch_is_round_robin_bitwise(kind):
    jsess = _plans(kind)[0].compile()
    jsess.init(jax.random.PRNGKey(5))
    state = _state_of(jsess)
    rr, l_rr = _port_fit(kind, state)
    pip, l_pip = _port_fit(kind, state, schedule="pipelined")
    assert torch.equal(l_rr, l_pip)
    for a, b in zip(tmod.tree_leaves(rr.state), tmod.tree_leaves(pip.state),
                    strict=True):
        assert torch.equal(a, b)
    assert _meter(rr) == _meter(pip)


def test_plan_validates_the_schedules():
    """The reference's checks and messages; what stays unported raises
    naming ROADMAP.md."""
    for mode in MODES:
        for plan in _plans(mode, microbatches=2):
            with pytest.raises(ValueError,
                               match="requires schedule='pipelined'"):
                plan.compile(**({} if isinstance(plan, JPlan)
                                else {"device": "cpu"}))
        _, tplan = _plans(mode, schedule="pipelined", microbatches=0)
        with pytest.raises(ValueError, match="microbatches must be >= 1"):
            tplan.compile(device="cpu")
        _, tplan = _plans(mode, schedule="pipelined", microbatches=2,
                          fleet=object())
        with pytest.raises(ValueError, match="single-mesh"):
            tplan.compile(device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _plans(mode, fleet=object())[1].compile(device="cpu")
    with pytest.raises(ValueError, match="single-mesh"):
        _plans("vanilla", schedule="pipelined", microbatches=2,
               fleet=JFleetSpec(n_devices=1))[0].compile()
    # an LM's SplitFns takes the pipelined schedule too
    lm = build_model(get_config("phi4_mini_3_8b").reduced(vocab=64))
    eng = Plan(mode="vanilla", model=lm_split_fns(lm, 1), cut=1,
               schedule="pipelined", microbatches=2).compile(
                   device="cpu").engine
    assert (eng.schedule, eng.microbatches) == ("pipelined", 2)
    # a batch the microbatch count does not divide
    sess = _plans("vanilla", schedule="pipelined",
                  microbatches=3)[1].compile(device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        sess.run_round(_round_batches("vanilla")[0][1])
    assert Plan(mode="vertical", schedule="pipelined").effective_schedule \
        == "pipelined"
    assert Plan(mode="vanilla", schedule="parallel").effective_schedule \
        == "parallel"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("mode,schedule,m", [("vanilla", "parallel", 1),
                                             ("u_shaped", "pipelined", 2)],
                         ids=["vanilla-parallel", "u_shaped-pipelined-M2"])
def test_schedules_on_card_match_cpu(mode, schedule, m):
    """Over the physical wire: 3 rounds on the card (the wire kernels)
    against the CPU (their plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    jsess = _plans(mode)[0].compile()
    jsess.init(jax.random.PRNGKey(6))
    _, tplan = _plans(mode, schedule=schedule, microbatches=m)
    on_cpu, on_card = tplan.compile(device="cpu"), tplan.compile()
    on_cpu.state = _state_of(jsess)
    on_card.state = bridge.tree_from_jax(_np_tree(jsess.state),
                                         device="cuda")
    batches = _round_batches(mode)
    lc = torch.stack([on_card.run_round(b[1]) for b in batches])
    lt = torch.stack([on_cpu.run_round(b[1]) for b in batches])
    np.testing.assert_allclose(lc.cpu().numpy(), lt.numpy(), rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(tmod.tree_leaves(on_card.state),
                    tmod.tree_leaves(on_cpu.state), strict=True):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
    assert on_card.meter() == on_cpu.meter()
