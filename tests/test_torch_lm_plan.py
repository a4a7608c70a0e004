"""The port's LM split training through `Plan` against the JAX Session,
on the CPU.

`Plan(mode="vanilla", model=lm_split_fns(model, cut), n_clients=2)` over
reduced phi4-mini (dense GQA, cut 1), Mamba2 (SSM, cut 1, a sequence of
two chunks) and RecurrentGemma (hybrid: two (rglru, rglru, attn)
super-blocks, window 8, cut 3 at the super-block boundary, a sequence
past the window), vocab 64, fp32 with TF32 off, 2 clients of 2 rows a
turn, 3 rounds.  Both packages start from the reference's init, carried
over by `bridge.lm_state_from_jax`; tokens are drawn with numpy from a
seed and handed to both.  Tolerances, each with its reason:

* per-turn losses, states after 3 rounds and evaluation accuracy: rtol
  = atol = 1e-5 (the matmuls and scans sum in other orders);
* client FLOPs: torch's counter over XLA's cost model, held to the band
  measured here for each family (`FLOP_RATIO_BAND`), as
  `tests/test_torch_vanilla.py` holds the VGG's;
* leakage (distance correlation over 32 rows): rtol = atol = 1e-4, as in
  `tests/test_torch_vanilla.py`;
* wire records, wire reports and metered bytes: exactly equal, and
  equal to their closed forms; the physical wire trains bitwise like the
  fake wire, and pipelined with one microbatch bitwise like round-robin
  (the same arithmetic).

Every fit runs SGD with momentum (lr 0.02, 0.9): at lr 0.05 Mamba2's
dynamics already amplify the float32 differences, and its embedding's
momentum is 3.9e-5 (of 1.24) apart by round 3.  Under AdamW at 1e-3
the reduced LMs drift a whole Adam step apart within 2 rounds: many of
their gradients are near zero (embedding rows of tokens a batch barely
holds, the Mamba2 conv's spread weights), where Adam divides two tiny
moments, so a difference in the last bits of a gradient moves a weight
by up to the learning rate (Mamba2: 0.002 in the conv weights after 2
rounds), and the next round's losses follow.

A quantized wire rounds each value to one of 255 levels, so a value
within the frameworks' fp32 difference of a rounding boundary rounds
differently in the two, and that value then moves by a whole level.  A
weight payload (the p2p handoff of a client's whole tree, a baseline's
model pull) is tens of thousands of values that differ between the
frameworks by about 1e-7 after a step, and some of them always cross a
boundary (about 5e-4 for an embedding weight).  The cut's crossings are
a few thousand values: phi4-mini's differ by about 5e-7 of their scale
and the seeds below put none on a boundary, but the SSD's and the RG-LRU
scan's sums differ by about 3e-6 of the cut gradient's scale, and some of
Mamba2's and RecurrentGemma's cut gradients change level within the
first round.  So each family's trajectory is held to the reference over
the dense wire with the p2p handoff; the quantized wires' trajectory is
held to it for phi4-mini under sync="none" (the cut alone); and for every
family the physical wire trains bitwise like the fake wire and bills the
reference's bytes (cut, handoff and model payloads) exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.api import FullFns as JFullFns
from repro.api import Plan as JPlan
from repro.api import SplitFns as JSplitFns
from repro.api import leakage_probe as jleakage_probe
from repro.api import lm_split_fns as jlm_split_fns
from repro.api import quantize_int8 as jquantize_int8
from repro.configs import get_config as jget_config
from repro.engine import topology as jtopo
from repro.models import build_model as jbuild_model
from repro_torch import bridge, optim
from repro_torch.api import (FullFns, Plan, SplitFns, leakage_probe,
                             lm_split_fns, quantize_int8)
from repro_torch.configs import get_config
from repro_torch.engine import copy_tree
from repro_torch.engine import topology as topo
from repro_torch.models import build_model
from repro_torch.nn import module as tmod
from _torch_threads import one_torch_thread

one_torch_thread()

TOL = dict(rtol=1e-5, atol=1e-5)
# torch counter FLOPs / XLA cost-model FLOPs of the client forward, as
# measured by test_lm_flops_ratio_to_xla
# (0.988, 1.063 and 0.996: XLA also counts the elementwise work, and
# Mamba2's chunked scan is einsums that torch's counter sees in full)
FLOP_RATIO_BAND = {"phi4_mini_3_8b": (0.98, 0.99),
                   "mamba2_130m": (1.06, 1.07),
                   "recurrentgemma_2b": (0.99, 1.0)}
LEAK_TOL = dict(rtol=1e-4, atol=1e-4)
N_CLIENTS, ROUNDS, B, EVAL_B = 2, 3, 2, 32
LR = 0.02
SCHED_ARCH = "phi4_mini_3_8b"          # the family of the one-family tests
FAMILIES = {
    # arch: (reduced overrides, sequence, cut)
    "phi4_mini_3_8b": (dict(vocab=64), 12, 1),
    "mamba2_130m": (dict(vocab=64), 16, 1),              # chunk 8: 2 chunks
    "recurrentgemma_2b": (dict(vocab=64, n_layers=6, window=8), 20, 3),
}
WIRES = {"dense": (lambda: [], lambda: []),
         "fake": (lambda: [jquantize_int8()], lambda: [quantize_int8()]),
         "physical": (lambda: [jquantize_int8(physical=True),
                               jleakage_probe()],
                      lambda: [quantize_int8(physical=True),
                               leakage_probe()])}


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_states(t_state, j_state, tol=TOL):
    t_leaves = jax.tree_util.tree_leaves(bridge.lm_state_to_numpy(t_state))
    j_leaves = jax.tree_util.tree_leaves(_np_tree(j_state))
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        if tol is None:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **tol)


def _models(arch):
    red, seq, cut = FAMILIES[arch]
    return (jbuild_model(jget_config(arch).reduced(**red)),
            build_model(get_config(arch).reduced(**red)), seq, cut)


def _tokens(seed, lead, seq, vocab=64):
    """{"tokens", "labels"} of `lead` + (seq,) in both packages, drawn by
    `data/synthetic.py:lm_batch`'s rule (next = (5 cur + noise) % vocab,
    noise in [0, 7)) so that three rounds can learn."""
    rng = np.random.default_rng(seed)
    toks = [rng.integers(0, vocab, lead)]
    for n in rng.integers(0, 7, (seq,) + lead):
        toks.append((5 * toks[-1] + n) % vocab)
    toks = np.stack(toks, axis=-1)
    return ({"tokens": jnp.asarray(toks[..., :-1], jnp.int32),
             "labels": jnp.asarray(toks[..., 1:], jnp.int32)},
            {"tokens": torch.from_numpy(toks[..., :-1]),
             "labels": torch.from_numpy(toks[..., 1:])})


def _plans(arch, mode="vanilla", wire="physical", **over):
    jm, tm, _, cut = _models(arch)
    jw, tw = WIRES[wire]
    if mode == "vanilla":
        jkw = dict(model=jlm_split_fns(jm, cut), cut=cut)
        tkw = dict(model=lm_split_fns(tm, cut), cut=cut)
    else:
        jkw = dict(model=JFullFns(init=jm.init, apply=jm.forward))
        tkw = dict(model=FullFns(init=tm.init, apply=tm.forward))
    common = dict(mode=mode, n_clients=N_CLIENTS, **over)
    return (JPlan(optimizer=joptim.sgd(LR, 0.9), wire=jw(), **common,
                  **jkw),
            Plan(optimizer=optim.sgd(LR, 0.9), wire=tw(), **common, **tkw))


def _batches(arch):
    seq = FAMILIES[arch][1]
    return [_tokens(100 + r, (N_CLIENTS, B), seq) for r in range(ROUNDS)]


def _fit(arch, mode="vanilla", wire="physical", **over):
    """Both packages from the reference's init, ROUNDS rounds: (jax
    session, port session, [jax losses], [port losses])."""
    jplan, tplan = _plans(arch, mode, wire, **over)
    jsess = jplan.compile()
    jsess.init(jax.random.PRNGKey(0))
    tsess = tplan.compile(device="cpu")
    tsess.state = bridge.lm_state_from_jax(_np_tree(jsess.state))
    batches = _batches(arch)
    lj = [np.asarray(jsess.run_round(b[0])) for b in batches]
    lt = [tsess.run_round(b[1]).numpy() for b in batches]
    return jsess, tsess, lj, lt


def _cut_bytes(arch, wire):
    """One crossing of the cut a turn: (B, S, D) fp32 dense, or int8 plus
    one fp32 scale a row of D."""
    jm, _, seq, _ = _models(arch)
    d = jm.cfg.d_model
    return B * seq * (4 * d if wire == "dense" else d + 4)


def _handoff_bytes(client_tree, wire):
    """The p2p handoff of one client's leaves: dense fp32, or each leaf
    as int8 plus one fp32 scale a last-axis row."""
    leaves = tmod.tree_leaves(client_tree)
    if wire == "dense":
        return sum(4 * t.numel() for t in leaves)
    return sum(t.numel() + 4 * (t.numel() // t.shape[-1]) for t in leaves)


def _check_meter(arch, wire, sync, tsess):
    """Per client: ROUNDS x (activation up + gradient down), plus under
    p2p the analytic handoff on every turn but client 0's first."""
    mt = tsess.meter()
    cut = _cut_bytes(arch, wire)
    handoff = _handoff_bytes(
        tmod.tree_map(lambda t: t[0], tsess.state["clients"]), wire)
    h = ([ROUNDS - 1] + [ROUNDS] * (N_CLIENTS - 1) if sync == "p2p"
         else [0] * N_CLIENTS)
    assert tsess.engine.meter.sync_bytes == [k * handoff for k in h]
    assert mt["client_gb"] == [(ROUNDS * 2 * cut + k * handoff) / 1e9
                               for k in h]
    assert (mt["client_gb"][0] < mt["client_gb"][1]) == (sync == "p2p")
    return cut, handoff


def _check_fit(arch, wire, sync):
    """Both packages ROUNDS rounds from the reference's init: per-turn
    losses and the whole state, the meter (against the reference's and
    the closed form), the wire report, the FLOP band, each client's
    accuracy and the leakage report on a tokens batch (the raw input is
    the batch's first value)."""
    jsess, tsess, lj, lt = _fit(arch, wire=wire, sync=sync)
    assert all(a.shape == (N_CLIENTS,) for a in lt)
    np.testing.assert_allclose(np.stack(lt), np.stack(lj), **TOL)
    _assert_states(tsess.state, jsess.state)
    assert int(tsess.state["last_trained"]) == N_CLIENTS - 1
    assert tsess.state["opt_c"]["step"].tolist() == [ROUNDS] * N_CLIENTS
    # the tied head and the client's embedding train as two leaves
    if "tied_head" in tsess.state["server"]:
        head = tsess.state["server"]["tied_head"]["table"]
        emb = tsess.state["clients"]["embed"]["table"]
        assert not any(torch.equal(head, emb[i]) for i in range(N_CLIENTS))

    mj, mt = jsess.meter(), tsess.meter()
    assert mt["client_gb"] == mj["client_gb"]
    for name in ("bytes_up", "bytes_down", "sync_bytes"):
        assert getattr(tsess.engine.meter, name) == getattr(
            jsess.engine.meter, name)
    cut, _ = _check_meter(arch, wire, sync, tsess)
    batch_j, batch_t = _batches(arch)[0]
    rep_t = tsess.wire_report(batch_t)
    assert rep_t == jsess.wire_report(batch_j)
    assert [r["bytes"] for r in rep_t] == [cut, cut]
    assert all(r["physical"] == (wire == "physical") for r in rep_t)

    ft, fj = mt["client_tflops"], mj["client_tflops"]
    assert len(set(ft)) == 1 and len(set(fj)) == 1 and fj[0] > 0
    lo, hi = FLOP_RATIO_BAND[arch]
    assert lo <= ft[0] / fj[0] <= hi, ft[0] / fj[0]

    ev_j, ev_t = _tokens(200, (EVAL_B,), FAMILIES[arch][1])
    for ci in range(N_CLIENTS):
        np.testing.assert_allclose(float(tsess.evaluate(ev_t, client=ci)),
                                   float(jsess.evaluate(ev_j, client=ci)),
                                   **TOL)
        rt = tsess.leakage_report(ev_t, client=ci)
        rj = jsess.leakage_report(ev_j, client=ci)
        assert rt.keys() == rj.keys() == {"dcor_input_vs_act",
                                          "dcor_label_vs_act"}
        for k in rj:
            np.testing.assert_allclose(rt[k], rj[k], **LEAK_TOL)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_lm_fit_over_the_dense_wire_matches_reference(arch):
    """Round-robin with the p2p handoff over the dense wire."""
    _check_fit(arch, "dense", "p2p")


def test_lm_fit_over_the_quantized_wires_matches_reference():
    """phi4-mini over the physical and the fake wire, the cut alone
    (sync="none"; see the module docstring)."""
    for wire in ("physical", "fake"):
        _check_fit(SCHED_ARCH, wire, "none")


def test_lm_physical_wire_bills_the_reference_and_trains_like_fake():
    """Each family round-robin with the p2p handoff over the physical
    wire: the wire report is the reference's; the meter is the closed
    form with client 0 one handoff short, a handoff billed at the
    reference's bytes for the same tree; and over the fake wire from the
    same state the losses, the whole final state and the meter are
    bitwise the same."""
    for arch in FAMILIES:
        _physical_like_fake(arch)


def _physical_like_fake(arch):
    from repro.api.wire import WireStack as JWireStack

    jplan, tplan = _plans(arch)
    sess = tplan.compile(device="cpu")
    sess.init(seed=4)
    start = copy_tree(sess.state)
    batches = _batches(arch)
    assert sess.wire_report(batches[0][1]) == jplan.compile().wire_report(
        batches[0][0])
    losses = torch.stack([sess.run_round(b[1]) for b in batches])
    _, handoff = _check_meter(arch, "physical", "p2p", sess)
    pc = tmod.tree_map(lambda t: t[0], start["clients"])
    jpc = jax.tree_util.tree_map(
        jnp.asarray, bridge.lm_state_to_numpy({"server": pc})["server"])
    stack = JWireStack([jquantize_int8(physical=True), jleakage_probe()])
    assert stack.handoff_bytes(jpc) == handoff

    fake = _plans(arch, wire="fake")[1].compile(device="cpu")
    fake.state = start
    lf = torch.stack([fake.run_round(b[1]) for b in batches])
    assert torch.equal(lf, losses) and fake.meter() == sess.meter()
    assert all(torch.equal(a, b) for a, b in zip(
        tmod.tree_leaves(fake.state), tmod.tree_leaves(sess.state),
        strict=True))


def test_lm_state_bridges_both_ways():
    """A reference LM Session state (stacked clients, stacked group
    layers, optimizer moments) crosses into the port and back leaf for
    leaf, for a split mode and for both baselines."""
    arch = "recurrentgemma_2b"
    for mode in ("vanilla", "large_batch", "fedavg"):
        jplan, tplan = _plans(arch, mode)
        jsess = jplan.compile()
        jsess.init(jax.random.PRNGKey(1))
        state = bridge.lm_state_from_jax(_np_tree(jsess.state))
        _assert_states(state, jsess.state, None)
        if mode == "vanilla":
            groups = state["clients"]["groups"]
            assert isinstance(groups[0], list) and len(groups[0]) == 1
            assert tuple(groups[0][0]["0"]["mixer"]["lam"].shape) == (
                N_CLIENTS, 128)
            assert len(state["server"]["groups"][0]) == 1
            assert state["opt_c"]["step"].dtype == torch.int32
        tsess = tplan.compile(device="cpu")
        tsess.state = state
        tsess.run_round(_batches(arch)[0][1])
        back = bridge.lm_state_from_jax(bridge.lm_state_to_numpy(
            tsess.state))
        for a, b in zip(tmod.tree_leaves(back), tmod.tree_leaves(
                tsess.state)):
            assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the other schedules and the baselines, one family
# ---------------------------------------------------------------------------

def test_lm_schedules_and_baselines_match_reference():
    """The one family under the other schedules and as the baselines'
    model: SplitFed over the physical wire (no handoff) and the
    2-microbatch pipeline over the dense wire (its handoff squeezes no
    weight) against the JAX Session, then the pipeline over the physical
    wire billing round-robin's meter byte for byte and at one microbatch
    training bitwise like round-robin; large_batch and fedavg over
    `FullFns`, over the dense wire against the JAX Session and over the
    physical wire billing the reference's model bytes."""
    for schedule, m in (("parallel", 1), ("pipelined", 2)):
        _schedule_matches_reference(schedule, m)
    _pipelined_one_microbatch_is_round_robin()
    for mode in ("large_batch", "fedavg"):
        _baseline_matches_reference(mode)


def _schedule_matches_reference(schedule, m):
    wire = "physical" if schedule == "parallel" else "dense"
    jsess, tsess, lj, lt = _fit(SCHED_ARCH, wire=wire, schedule=schedule,
                                microbatches=m)
    np.testing.assert_allclose(np.stack(lt), np.stack(lj), **TOL)
    _assert_states(tsess.state, jsess.state)
    assert tsess.meter()["client_gb"] == jsess.meter()["client_gb"]
    if schedule == "parallel":
        _check_meter(SCHED_ARCH, wire, "none", tsess)
        return
    meters = []
    for over in ({}, dict(schedule="pipelined", microbatches=m)):
        s = _plans(SCHED_ARCH, **over)[1].compile(device="cpu")
        s.init(seed=6)
        for b in _batches(SCHED_ARCH):
            s.run_round(b[1])
        meters.append([getattr(s.engine.meter, name) for name in
                       ("bytes_up", "bytes_down", "sync_bytes")])
        _check_meter(SCHED_ARCH, "physical", "p2p", s)
    assert meters[0] == meters[1]


def _pipelined_one_microbatch_is_round_robin():
    sess = _plans(SCHED_ARCH)[1].compile(device="cpu")
    sess.init(seed=2)
    runs = []
    for over in ({}, dict(schedule="pipelined", microbatches=1)):
        s = _plans(SCHED_ARCH, **over)[1].compile(device="cpu")
        s.state = copy_tree(sess.state)
        losses = torch.stack([s.run_round(b[1])
                              for b in _batches(SCHED_ARCH)])
        runs.append((losses, tmod.tree_leaves(s.state), s.meter()))
    (la, sa, ma), (lb, sb, mb) = runs
    assert torch.equal(la, lb) and ma == mb
    assert all(torch.equal(a, b) for a, b in zip(sa, sb))


def _baseline_matches_reference(mode):
    jsess, tsess, lj, lt = _fit(SCHED_ARCH, mode, wire="dense")
    np.testing.assert_allclose(np.stack(lt), np.stack(lj), **TOL)
    _assert_states(tsess.state, jsess.state)
    assert tsess.meter()["client_gb"] == jsess.meter()["client_gb"]
    ev_j, ev_t = _tokens(200, (EVAL_B,), FAMILIES[SCHED_ARCH][1])
    np.testing.assert_allclose(float(tsess.evaluate(ev_t)),
                               float(jsess.evaluate(ev_j)), **TOL)
    batch_j, batch_t = _batches(SCHED_ARCH)[0]
    jplan, tplan = _plans(SCHED_ARCH, mode)
    phys = tplan.compile(device="cpu")
    phys.init(seed=0)
    rep = phys.wire_report(batch_t)
    assert rep == jplan.compile().wire_report(batch_j)
    model = _handoff_bytes(phys.state["global"], "physical")
    assert [r["bytes"] for r in rep] == [model, model]
    for b in _batches(SCHED_ARCH):
        phys.run_round(b[1])
    assert phys.engine.meter.bytes_up == [ROUNDS * model] * N_CLIENTS
    assert phys.engine.meter.bytes_down == [ROUNDS * model] * N_CLIENTS


def test_split_fns_errors_match_reference():
    """A baseline over SplitFns takes its full_apply; without one, and in
    a split mode other than vanilla, both packages raise the same
    ValueError."""
    jm, tm, _, cut = _models(SCHED_ARCH)
    sess = Plan(mode="large_batch", model=lm_split_fns(tm, cut),
                n_clients=2).compile(device="cpu")
    assert set(sess.init(seed=0)) == {"global", "opt"}
    bare_t = SplitFns(init=tm.init, split=None, client_apply=None,
                      server_apply=None)
    bare_j = JSplitFns(init=jm.init, split=None, client_apply=None,
                       server_apply=None)
    for mode, kw, match in (
            ("fedavg", {}, "full_apply is required"),
            ("large_batch", {}, "full_apply is required"),
            ("u_shaped", dict(cuts=(1, 2)), "needs model= \\(SegModel\\)"),
            ("multihop", dict(cuts=[1]), "needs model= \\(SegModel\\)")):
        for plan, dev in ((JPlan(mode=mode, model=bare_j, **kw), {}),
                          (Plan(mode=mode, model=bare_t, **kw),
                           {"device": "cpu"})):
            with pytest.raises(ValueError, match=match):
                plan.compile(**dev)
    with pytest.raises(ValueError, match="needs cut="):
        Plan(mode="vanilla", model=bare_t).compile(device="cpu")
    jprog = jtopo.lower(jtopo.vanilla_fns(None, None, None, None))
    tprog = topo.lower(topo.vanilla_fns(None, None, None, None))
    assert tprog.describe() == jprog.describe()
    assert tprog.billed_wires(0) == jprog.billed_wires(0)
