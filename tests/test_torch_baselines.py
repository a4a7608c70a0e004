"""The port's two comparison baselines (fedavg, large_batch) and the
paper's analytic Table 1/2 costs against the JAX reference, on the CPU.

Inputs are seeded numpy arrays handed to both packages; parameters and
whole engine states come from the JAX side through `repro_torch.bridge`.
The model is the whole smoke VGG (`configs/vgg_cifar10.py:SMOKE`, 7
segments, 10 leaves), 3 clients, fedavg with 2 local steps.  Everything
is fp32 with TF32 off.  Tolerances, each with its reason:

* model-payload bytes, packed payloads given the same dense value (int8
  `q` and row scales), wire reports, metered bytes, `describe()` and the
  analytic costs: exactly equal; the physical wire trains bitwise like
  the fake wire, and a round computed by hand from the plain pieces
  equals the engine's bitwise (the same arithmetic);
* losses, states after 3 rounds and evaluation: rtol = atol = 1e-5 (the
  two frameworks sum convolutions in different orders).  The dense-wire
  fedavg case runs SGD with momentum: under AdamW at 1e-3, 6 of conv 1's
  216 weights drift up to 5.1e-5 apart in 3 rounds of 2 local steps, where
  Adam divides two moments whose gradients nearly cancel (the quantized
  wires' cases stay inside the tolerance under AdamW);
* FLOPs: torch's counter over XLA's cost model of the whole forward is
  held to `tests/test_torch_vanilla.py:FLOP_RATIO_BAND`.

A quantized wire rounds each value to one of 255 levels, so a value
within the frameworks' fp32 difference of a rounding boundary would round
differently in the two; the seeds below put none there.

The test marked `gpu` trains on the card against the CPU and skips
without a CUDA GPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.api import Plan as JPlan
from repro.api import leakage_probe as jleakage_probe
from repro.api import quantize_int8 as jquantize_int8
from repro.api.wire import WireStack as JWireStack
from repro.configs import vgg_cifar10 as jvgg_cfg
from repro.core import accounting as jacc
from repro.core import split as jsp
from repro.core import wire_compress as jwc
from repro.engine import topology as jtopo
from repro.nn import convnets as JC
from repro_torch import bridge, optim
from repro_torch.api import (FullFns, Plan, SplitFns, WireAccountingError,
                             WireStack, leakage_probe, quantize_int8,
                             softmax_xent)
from repro_torch.configs import vgg_cifar10 as tvgg_cfg
from repro_torch.core import accounting as acc
from repro_torch.core import split as sp
from repro_torch.core import wire_compress as twc
from repro_torch.engine import copy_tree, stack_trees, tree_at
from repro_torch.engine import topology as topo
from repro_torch.nn import convnets as TC
from repro_torch.nn import module as tmod
from repro_torch.optim import apply_updates

TOL = dict(rtol=1e-5, atol=1e-5)
# torch counter FLOPs / XLA cost-model FLOPs of the whole smoke-VGG
# forward at 32 x 32: 1.024, inside tests/test_torch_vanilla.py's band
FLOP_RATIO_BAND = (1.02, 1.03)
N_CLIENTS, ROUNDS, HW, N_CLS, LOCAL_STEPS = 3, 3, 32, 4, 2
# the smoke VGG's 10 leaves through the int8 wire: int8 values plus one
# fp32 scale a last-axis row
MODEL_WIRE_BYTES = ((27 * 8 + 27 * 4) + (8 + 4) + (72 * 8 + 72 * 4)
                    + (8 + 4) + (72 * 8 + 72 * 4) + (8 + 4)
                    + (8 * 128 + 8 * 4) + (128 + 4) + (128 * 4 + 128 * 4)
                    + (4 + 4))
MODEL_DENSE_BYTES = 4 * (216 + 8 + 576 + 8 + 576 + 8 + 1024 + 128 + 512
                         + 4)


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


def _models():
    cj, ct = jvgg_cfg.SMOKE, tvgg_cfg.SMOKE
    plan_j, plan_t = JC.vgg_plan(cj), TC.vgg_plan(ct)
    jm = jsp.list_segmodel(len(plan_j), lambda k: JC.vgg_init(k, cj),
                           lambda p, i, x: JC.vgg_layer_apply(p, plan_j[i], x))
    tm = sp.list_segmodel(len(plan_t), lambda g: TC.vgg_init(g, ct),
                          lambda p, i, x: TC.vgg_layer_apply(p, plan_t[i], x))
    return jm, tm


def _batch(seed, lead):
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


WIRES = {"dense": (lambda: [], lambda: []),
         "fake": (lambda: [jquantize_int8()], lambda: [quantize_int8()]),
         "physical": (lambda: [jquantize_int8(physical=True),
                               jleakage_probe()],
                      lambda: [quantize_int8(physical=True),
                               leakage_probe()])}
MODES = ("fedavg", "large_batch")


def _plans(mode, wire, opt="adamw"):
    """AdamW at the `Plan` default of 1e-3, or SGD with momentum 0.9 at
    0.05."""
    jm, tm = _models()
    jw, tw = WIRES[wire]
    kw = dict(n_clients=N_CLIENTS)
    if mode == "fedavg":
        kw["local_steps"] = LOCAL_STEPS
    jopt, topt = ((joptim.adamw(1e-3), optim.adamw(1e-3)) if opt == "adamw"
                  else (joptim.sgd(0.05, 0.9), optim.sgd(0.05, 0.9)))
    return (JPlan(mode=mode, model=jm, optimizer=jopt, wire=jw(), **kw),
            Plan(mode=mode, model=tm, optimizer=topt, wire=tw(), **kw))


def _sessions(mode, wire, seed=0, opt="adamw"):
    jplan, tplan = _plans(mode, wire, opt)
    jsess = jplan.compile()
    jsess.init(jax.random.PRNGKey(seed))
    tsess = tplan.compile(device="cpu")
    tsess.state = bridge.tree_from_jax(_np_tree(jsess.state))
    return jsess, tsess


def _round_batches():
    return ([_batch(300 + r, (N_CLIENTS, 8)) for r in range(ROUNDS)],
            _batch(300 + ROUNDS, (64,)))


# ---------------------------------------------------------------------------
# the step programs and the model payload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_baseline_step_programs_match_reference(mode):
    pj = jtopo.lower_baseline(mode, local_steps=LOCAL_STEPS)
    pt = topo.lower_baseline(mode, local_steps=LOCAL_STEPS)
    assert pt.describe() == pj.describe()
    assert pt.kind == pt.round_type == pj.round_type == mode
    assert [s.name for s in pt.handoff_steps()] == [
        s.name for s in pj.handoff_steps()]
    assert pt.wire_steps() == ()
    if mode == "fedavg":
        assert f"repeats={LOCAL_STEPS}" in pt.describe()[1]
    with pytest.raises(ValueError, match="unknown baseline"):
        topo.lower_baseline("vanilla")


@pytest.mark.parametrize("physical", [False, True], ids=["fake", "physical"])
def test_model_payload_bytes_and_packs_match_reference(physical):
    """The model payload priced leafwise through the stack, the packed
    payload of every leaf given the same dense value, and a stacked
    (N, ...) push leaf packed in one call being the per-client packs."""
    jsess, tsess = _sessions("fedavg", "physical" if physical else "fake")
    gj, gt = jsess.state["global"], tsess.state["global"]
    sj = JWireStack([jquantize_int8(physical=physical), jleakage_probe()])
    st = WireStack([quantize_int8(physical=physical), leakage_probe()])
    assert st.tree_wire_bytes(gt) == sj.tree_wire_bytes(gj) == \
        MODEL_WIRE_BYTES
    assert tsess.engine._wire_model_bytes(gt) == \
        jsess.engine._wire_model_bytes(gj) == MODEL_WIRE_BYTES
    assert WireStack([]).tree_wire_bytes(gt) == MODEL_DENSE_BYTES
    stacked = stack_trees([tmod.tree_map(lambda a, k=k: a * (k + 1), gt)
                           for k in range(N_CLIENTS)])
    for leaf_t, leaf_j in zip(tmod.tree_leaves(stacked),
                              jax.tree_util.tree_leaves(
                                  _np_tree(jax.tree_util.tree_map(
                                      lambda a: jnp.stack(
                                          [a * (k + 1) for k in
                                           range(N_CLIENTS)]), gj)))):
        own = twc.pack_int8(leaf_t)
        ref = jwc.pack_int8(jnp.asarray(leaf_j))
        np.testing.assert_array_equal(own.q.numpy(), np.asarray(ref.q))
        np.testing.assert_array_equal(own.scale.numpy(),
                                      np.asarray(ref.scale))
        for k in range(N_CLIENTS):      # per last-axis row: per client
            one = twc.pack_int8(leaf_t[k])
            assert torch.equal(one.q, own.q[k])
            assert torch.equal(one.scale, own.scale[k])


def test_model_wire_accounting_error_on_drift():
    """A physical transform whose byte claim drifts from the packed
    payloads raises when the baseline prices its model wire."""
    _, tm = _models()
    liar = dataclasses.replace(quantize_int8(physical=True),
                               bytes_fn=lambda shape, dtype, nbytes: nbytes)
    sess = Plan(mode="large_batch", model=tm, n_clients=2,
                wire=[liar]).compile(device="cpu")
    batches, _ = _round_batches()
    with pytest.raises(WireAccountingError, match="baseline model wire"):
        sess.wire_report([{k: v[0] for k, v in batches[0][1].items()}] * 2)


# ---------------------------------------------------------------------------
# the rounds, computed by hand from the plain pieces
# ---------------------------------------------------------------------------

def _hand_grad(apply, params, batch):
    with torch.enable_grad():
        p = sp._leaf_params(params)
        loss = softmax_xent(apply(p, batch), batch["labels"])
        return loss.detach(), sp._grads(loss, p)


def test_fedavg_round_semantics():
    """One pull through the wire shared by every client; every local step
    reuses the client's batch; each client's optimizer state carries on
    while its params restart from the pull; the stacked push is quantized
    then averaged.  The engine's round equals this one bitwise."""
    _, tsess = _sessions("fedavg", "fake")
    eng = tsess.engine
    batches, _ = _round_batches()
    st = copy_tree(tsess.state)
    q = lambda t: tmod.tree_map(twc._fake_quant_int8, t)
    pulled = q(st["global"])
    locals_, opts, losses = [], [], []
    for ci in range(N_CLIENTS):
        batch = {k: v[ci] for k, v in batches[0][1].items()}
        p, o = pulled, tree_at(st["opt"], ci)
        for _ in range(LOCAL_STEPS):
            loss, g = _hand_grad(eng.apply_fn, p, batch)
            ups, o = eng.optimizer.update(g, o, p)
            p = apply_updates(p, ups)
        locals_.append(p)
        opts.append(o)
        losses.append(loss)
    want = tmod.tree_map(lambda a: a.mean(0), q(stack_trees(locals_)))
    got = tsess.run_round(batches[0][1])
    torch.testing.assert_close(got, torch.stack(losses), rtol=0, atol=0)
    for a, b in zip(tmod.tree_leaves(tsess.state["global"]),
                    tmod.tree_leaves(want)):
        assert torch.equal(a, b)
    assert tsess.state["opt"]["step"].tolist() == [LOCAL_STEPS] * N_CLIENTS
    for a, b in zip(tmod.tree_leaves(tsess.state["opt"]),
                    tmod.tree_leaves(stack_trees(opts))):
        assert torch.equal(a, b)


def test_large_batch_round_semantics():
    """Gradients from the pulled, quantized params; the stacked gradients
    pushed through the wire and averaged; one AdamW update of the
    full-precision master.  The engine's step equals this one bitwise."""
    _, tsess = _sessions("large_batch", "fake")
    eng = tsess.engine
    batches, _ = _round_batches()
    st = copy_tree(tsess.state)
    q = lambda t: tmod.tree_map(twc._fake_quant_int8, t)
    pulled = q(st["global"])
    outs = [_hand_grad(eng.apply_fn, pulled,
                       {k: v[ci] for k, v in batches[0][1].items()})
            for ci in range(N_CLIENTS)]
    g = tmod.tree_map(lambda a: a.mean(0),
                      q(stack_trees([g for _, g in outs])))
    ups, _ = eng.optimizer.update(g, st["opt"], st["global"])
    want = apply_updates(st["global"], ups)
    got = tsess.run_round(batches[0][1])
    assert torch.equal(got, torch.stack([loss for loss, _ in outs]))
    for a, b in zip(tmod.tree_leaves(tsess.state["global"]),
                    tmod.tree_leaves(want)):
        assert torch.equal(a, b)
    assert int(tsess.state["opt"]["step"]) == 1


# ---------------------------------------------------------------------------
# Plan(mode=...) end to end
# ---------------------------------------------------------------------------

FIT_CASES = [("fedavg", "physical", "adamw"), ("fedavg", "dense", "sgd"),
             ("large_batch", "physical", "adamw"),
             ("large_batch", "fake", "adamw")]


@pytest.fixture(scope="module", params=FIT_CASES,
                ids=[f"{m}-{w}-{o}" for m, w, o in FIT_CASES])
def fitted(request):
    mode, wire, opt = request.param
    jsess, tsess = _sessions(mode, wire, opt=opt)
    batches, ev = _round_batches()
    lj = [np.asarray(jsess.run_round(b[0])) for b in batches]
    lt = [tsess.run_round(b[1]).numpy() for b in batches]
    return mode, wire, jsess, tsess, batches, ev, lj, lt


def test_baseline_fit_losses_and_state_match_reference(fitted):
    mode, _, jsess, tsess, _, _, lj, lt = fitted
    assert all(a.shape == (N_CLIENTS,) for a in lt)
    np.testing.assert_allclose(np.stack(lt), np.stack(lj), **TOL)
    _assert_trees(tsess.state, jsess.state, TOL)
    if mode == "fedavg":        # the per-client states carry on
        assert tsess.state["opt"].keys() == jsess.state["opt"].keys()
    steps = tsess.state["opt"]["step"]
    if mode == "fedavg":
        assert steps.tolist() == [ROUNDS * LOCAL_STEPS] * N_CLIENTS
    else:
        assert int(steps) == ROUNDS


def test_baseline_meter_and_wire_report_match_reference(fitted):
    """Each client is billed one model payload down and one up a round,
    and 3 x the forward FLOPs of its batch times the local steps."""
    mode, wire, jsess, tsess, batches, _, _, _ = fitted
    for name in ("bytes_up", "bytes_down", "sync_bytes"):
        assert getattr(tsess.engine.meter, name) == getattr(
            jsess.engine.meter, name)
    assert tsess.meter()["client_gb"] == jsess.meter()["client_gb"]
    payload = MODEL_DENSE_BYTES if wire == "dense" else MODEL_WIRE_BYTES
    assert tsess.engine.meter.bytes_up == [ROUNDS * payload] * N_CLIENTS
    assert tsess.engine.meter.bytes_down == tsess.engine.meter.bytes_up
    rep = tsess.wire_report(batches[0][1])
    assert rep == jsess.wire_report(batches[0][0])
    assert rep == [{"name": "model_pull", "direction": "down",
                    "bytes": payload, "physical": wire == "physical"},
                   {"name": "model_push", "direction": "up",
                    "bytes": payload, "physical": wire == "physical"}]
    assert tsess.engine._param_bytes == MODEL_DENSE_BYTES


def test_baseline_flops_match_reference(fitted):
    mode, _, jsess, tsess, _, _, _, _ = fitted
    ft, fj = tsess.meter()["client_tflops"], jsess.meter()["client_tflops"]
    assert len(set(ft)) == 1 and fj[0] > 0
    lo, hi = FLOP_RATIO_BAND
    assert lo <= ft[0] / fj[0] <= hi, ft[0] / fj[0]
    per_batch = tsess.engine._flops_per_batch
    steps = LOCAL_STEPS if mode == "fedavg" else 1
    assert ft[0] == ROUNDS * steps * per_batch / 1e12


def test_baseline_evaluate_matches_reference(fitted):
    _, _, jsess, tsess, _, (ev_j, ev_t), _, _ = fitted
    assert float(tsess.evaluate(ev_t)) == float(jsess.evaluate(ev_j))
    acc = tsess.evaluate_all(ev_t)
    assert tuple(acc.shape) == (1,)
    np.testing.assert_array_equal(acc.numpy(),
                                  np.asarray(jsess.evaluate_all(ev_j)))
    assert not tsess.is_split and not jsess.is_split
    for sess, ev in ((tsess, ev_t), (jsess, ev_j)):
        with pytest.raises(ValueError, match="whole model"):
            sess.leakage_report(ev)


@pytest.mark.parametrize("mode", MODES)
def test_baseline_physical_wire_trains_bitwise_like_fake_wire(mode):
    _, tsess = _sessions(mode, "dense", seed=1)
    batches, _ = _round_batches()
    runs = {}
    for wire in ("fake", "physical"):
        s = _plans(mode, wire)[1].compile(device="cpu")
        s.state = copy_tree(tsess.state)
        runs[wire] = (torch.stack([s.run_round(b[1]) for b in batches]),
                      tmod.tree_leaves(s.state))
    (lf, sf), (lp, sp_) = runs["fake"], runs["physical"]
    assert torch.equal(lf, lp)
    assert len(sf) == len(sp_) and all(torch.equal(a, b)
                                       for a, b in zip(sf, sp_))


def test_baseline_wire_report_is_side_effect_free():
    _, tm = _models()
    sess = Plan(mode="fedavg", model=tm, n_clients=2,
                wire=[quantize_int8(physical=True)]).compile(device="cpu")
    batches, _ = _round_batches()
    shards = [{k: v[i] for k, v in batches[0][1].items()} for i in range(2)]
    rep = sess.wire_report(shards)
    assert sess.state is None and sess.engine.meter.bytes_up == [0, 0]
    assert sess.wire_report(shards) == rep
    assert rep[0]["bytes"] < sess.engine._param_bytes


def test_full_fns_and_unported_baseline_options():
    _, tm = _models()
    fns = FullFns(init=tm.init,
                  apply=lambda p, b: tm.apply_range(p, b["x"], 0, 7))
    sess = Plan(mode="large_batch", model=fns, n_clients=2).compile(
        device="cpu")
    st = sess.init(seed=2)
    assert set(st) == {"global", "opt"}
    split = SplitFns(init=None, split=None, client_apply=None,
                     server_apply=None)
    for mode in MODES:
        # a baseline over SplitFns runs its full_apply, and without one
        # raises the reference's error
        with pytest.raises(ValueError, match="full_apply is required"):
            Plan(mode=mode, model=split).compile(device="cpu")
        sess = Plan(mode=mode, model=dataclasses.replace(
            split, init=fns.init, full_apply=fns.apply),
            n_clients=2).compile(device="cpu")
        assert set(sess.init(seed=2)) == {"global", "opt"}
        # microbatches are ported under the pipelined schedule
        # (tests/test_torch_schedules.py)
        with pytest.raises(ValueError,
                           match="requires schedule='pipelined'"):
            Plan(mode=mode, model=tm, microbatches=2).compile(device="cpu")
        eng = Plan(mode=mode, model=tm, schedule="pipelined",
                   microbatches=2).compile(device="cpu").engine
        assert eng.microbatches == 2
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Plan(mode=mode, model=tm, fleet=object()).compile(device="cpu")
        with pytest.raises(TypeError, match="cannot run a baseline"):
            Plan(mode=mode, model=object()).compile(device="cpu")


# ---------------------------------------------------------------------------
# the analytic Table 1/2 costs
# ---------------------------------------------------------------------------

def test_analytic_costs_match_reference():
    assert acc.vgg16_param_count() == jacc.vgg16_param_count() == 14_982_474
    for kw in ({}, {"upto_layer": 1}, {"upto_layer": 2}, {"hw": 64}):
        assert acc.vgg16_flops_per_sample(**kw) == \
            jacc.vgg16_flops_per_sample(**kw)
    assert acc.resnet50_flops_per_sample() == \
        jacc.resnet50_flops_per_sample()
    assert acc.resnet50_param_count() == jacc.resnet50_param_count()
    for n in (1, 4, 10, 100):
        for cut in (1, 2):
            t = acc.paper_table1_setup(n, cut_layer=cut)
            j = jacc.paper_table1_setup(n, cut_layer=cut)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.fedavg() == j.fedavg() and t.lbsgd() == j.lbsgd()
            for sync in ("p2p", "none"):
                assert t.splitnn(sync=sync) == j.splitnn(sync=sync)
        t2, j2 = acc.paper_table2_setup(n), jacc.paper_table2_setup(n)
        assert dataclasses.asdict(t2) == dataclasses.asdict(j2)
        assert (t2.fedavg(), t2.lbsgd(), t2.splitnn()) == (
            j2.fedavg(), j2.lbsgd(), j2.splitnn())
    # the paper's Table 1 claim: splitNN's client compute is far below
    # the baselines'
    t = acc.paper_table1_setup(100)
    assert t.splitnn()["tflops"] < t.fedavg()["tflops"] == \
        t.lbsgd()["tflops"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_baselines_training_on_card_match_cpu():
    """fedavg and large_batch over the physical wire: 3 rounds on the card
    (the wire kernels) against the CPU (their plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    for mode in MODES:
        jsess, on_cpu = _sessions(mode, "physical")
        on_card = _plans(mode, "physical")[1].compile()
        on_card.state = bridge.tree_from_jax(_np_tree(jsess.state),
                                             device="cuda")
        batches, _ = _round_batches()
        lc = torch.stack([on_card.run_round(b[1]) for b in batches])
        lt = torch.stack([on_cpu.run_round(b[1]) for b in batches])
        np.testing.assert_allclose(lc.cpu().numpy(), lt.numpy(), rtol=1e-4,
                                   atol=1e-5)
        for a, b in zip(tmod.tree_leaves(on_card.state),
                        tmod.tree_leaves(on_cpu.state)):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
        assert on_card.meter() == on_cpu.meter()
