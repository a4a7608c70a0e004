"""The port's vertical (multi-modal) split training against the JAX
reference, on the CPU.

Inputs are seeded numpy arrays handed to both packages; parameters and
whole engine states come from the JAX side through `repro_torch.bridge`.
Everything is fp32 with TF32 off.  Tolerances, each with its reason:

* layers, VGG, grads, optimizer updates, losses and states: rtol = atol =
  1e-5 (the two frameworks sum convolutions and matmuls in different
  orders);
* leakage (distance correlation over pairwise-distance matrices):
  rtol = atol = 1e-4;
* wire records, wire reports and metered bytes: exactly equal;
* FLOPs: torch's flop counter counts matmuls and convolutions only, and
  a convolution's every tap, padding included; XLA's cost model also
  counts elementwise work but skips the taps that fall on SAME padding.
  Their ratio is held to the band measured here (`FLOP_RATIO_BAND`,
  written in PERF.md): below 1 for the MLP branch, above 1 for VGG.

A quantized wire rounds each crossing value to one of 255 levels, so a
value that lands within the frameworks' fp32 difference of a rounding
boundary would round differently in the two; the seeds below put none
there.

Tests marked `gpu` compare the card against the CPU and skip without a
CUDA GPU.
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
from repro.core import privacy as jprivacy
from repro.core import split as jsp
from repro.engine import topology as jtopo
from repro.nn import convnets as JC
from repro_torch import bridge, optim
from repro_torch.api import (MODES, PORTED_MODES, Plan, WireStack,
                             WireTape, leakage_probe, parse_wire,
                             quantize_int8, softmax_xent)
from repro_torch.configs import vgg_cifar10 as tvgg_cfg
from repro_torch.core import privacy
from repro_torch.core import split as sp
from repro_torch.data import synthetic
from repro_torch.engine import topology as topo
from repro_torch.engine import tree_at
from repro_torch.kernels import ops
from repro_torch.nn import convnets as TC
from repro_torch.nn import layers as TL
from repro_torch.nn import module as tmod

TOL = dict(rtol=1e-5, atol=1e-5)
LEAK_TOL = dict(rtol=1e-4, atol=1e-4)
# torch counter FLOPs / XLA cost-model FLOPs of the client forward, as
# measured by test_flops_ratio_to_xla (the band is written in PERF.md)
FLOP_RATIO_BAND = {"mlp": (0.98, 0.99), "vgg_smoke": (1.07, 1.08)}


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_close(t_tree, j_tree, tol=TOL):
    t_leaves = jax.tree_util.tree_leaves(bridge.tree_to_numpy(t_tree))
    j_leaves = jax.tree_util.tree_leaves(_np_tree(j_tree))
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)


# ---------------------------------------------------------------------------
# layers and VGG
# ---------------------------------------------------------------------------

CONV_CASES = [(3, 1, "SAME", 8), (3, 2, "SAME", 7), (3, 2, "SAME", 8),
              (3, 1, "VALID", 6), (1, 2, "SAME", 9)]


@pytest.mark.parametrize("ksize,stride,padding,hw", CONV_CASES,
                         ids=[f"k{k}s{s}-{p}-{h}" for k, s, p, h in CONV_CASES])
def test_conv2d_matches_reference(ksize, stride, padding, hw):
    pj = JL.conv2d_init(jax.random.PRNGKey(ksize + stride), 3, 5, ksize)
    pj["b"] = jnp.asarray(_x(1, (5,)))
    x = _x(2, (2, hw, hw, 3))
    yj = JL.conv2d_apply(pj, jnp.asarray(x), stride=stride, padding=padding)
    yt = TL.conv2d_apply(bridge.tree_from_jax(_np_tree(pj)),
                         torch.from_numpy(x), stride=stride, padding=padding)
    assert tuple(yt.shape) == yj.shape
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_pools_match_reference():
    x = _x(3, (2, 9, 8, 4))
    np.testing.assert_array_equal(
        TL.maxpool2d(torch.from_numpy(x)).numpy(),
        np.asarray(JL.maxpool2d(jnp.asarray(x))))
    np.testing.assert_allclose(
        TL.avgpool_global(torch.from_numpy(x)).numpy(),
        np.asarray(JL.avgpool_global(jnp.asarray(x))), **TOL)


# SMOKE, and the first block of VGG-16 at full width
VGG_CASES = {"smoke": (jvgg_cfg.SMOKE, tvgg_cfg.SMOKE, 16),
             "block1-full": (JC.CNNConfig(name="b1", plan=(64, 64, "M")),
                             TC.CNNConfig(name="b1", plan=(64, 64, "M")), 32)}


@pytest.mark.parametrize("case", list(VGG_CASES))
def test_vgg_layer_by_layer_matches_reference(case):
    cj, ct, hw = VGG_CASES[case]
    pj = JC.vgg_init(jax.random.PRNGKey(4), cj)
    # non-zero biases, so the bias paths are compared too
    pj = jax.tree_util.tree_map(
        lambda a: a + 0.1 if a.ndim == 1 else a, pj)
    pt = bridge.tree_from_jax(_np_tree(pj))
    x = _x(5, (2, hw, hw, 3))
    xj, plan = jnp.asarray(x), JC.vgg_plan(cj)
    assert TC.vgg_plan(ct) == plan
    for i, item in enumerate(plan):
        yj = JC.vgg_layer_apply(pj[i], item, xj)
        yt = TC.vgg_layer_apply(pt[i], item, torch.from_numpy(np.array(xj)))
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)
        xj = yj
    for lo, hi in ((0, len(plan)), (0, len(plan) - 1), (2, len(plan))):
        xin = x if lo == 0 else np.asarray(
            JC.vgg_apply(pj, cj, jnp.asarray(x), to_layer=lo))
        np.testing.assert_allclose(
            TC.vgg_apply(pt, ct, torch.from_numpy(np.array(xin)), from_layer=lo,
                         to_layer=hi).numpy(),
            np.asarray(JC.vgg_apply(pj, cj, jnp.asarray(xin), from_layer=lo,
                                    to_layer=hi)), **TOL)


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_vgg_init_matches_reference_shapes(name):
    cj, ct = getattr(jvgg_cfg, name), getattr(tvgg_cfg, name)
    shapes_j = jax.eval_shape(lambda k: JC.vgg_init(k, cj),
                              jax.random.PRNGKey(0))
    pt = TC.vgg_init(torch.Generator().manual_seed(0), ct)
    assert jax.tree_util.tree_structure(
        bridge.tree_to_numpy(pt)) == jax.tree_util.tree_structure(shapes_j)
    for a, b in zip(tmod.tree_leaves(pt),
                    jax.tree_util.tree_leaves(shapes_j)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    n_branch = tmod.param_count(pt[:len(ct.plan) + 1])
    if name == "CONFIG":        # the vertical branch: 13 convs + FC1
        assert n_branch == 14_977_344
        assert tmod.param_bytes(pt[:19]) == 4 * n_branch


def test_generator_streams_are_independent_and_seeded():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = [torch.randn(4, generator=k) for k in tmod.split_keys(g1, 3)]
    b = [torch.randn(4, generator=k) for k in tmod.split_keys(g2, 3)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1])
    w = tmod.lecun_init(torch.Generator().manual_seed(0), (400, 300),
                        torch.float32)
    assert abs(float(w.std()) - 400 ** -0.5) < 2e-3


# ---------------------------------------------------------------------------
# the vertical split's gradients
# ---------------------------------------------------------------------------

DIM, HID, DFEAT, N_CLASSES = 56, 40, 20, 4      # examples/multimodal_vertical


def _mlp_branches():
    jb = jsp.Branch(
        init=lambda k: {"l1": JL.dense_init(k, DIM, HID, bias=True),
                        "l2": JL.dense_init(k, HID, DFEAT, bias=True)},
        apply=lambda p, x: JL.dense_apply(
            p["l2"], jax.nn.relu(JL.dense_apply(p["l1"], x))))
    tb = sp.Branch(
        init=lambda g: {"l1": TL.dense_init(g, DIM, HID, bias=True),
                        "l2": TL.dense_init(g, HID, DFEAT, bias=True)},
        apply=lambda p, x: TL.dense_apply(
            p["l2"], torch.relu(TL.dense_apply(p["l1"], x))))
    jt = (lambda k: JL.dense_init(k, 2 * DFEAT, N_CLASSES, bias=True),
          JL.dense_apply)
    tt = (lambda g: TL.dense_init(g, 2 * DFEAT, N_CLASSES, bias=True),
          TL.dense_apply)
    return jb, tb, jt, tt, (DIM,), N_CLASSES


def _vgg_branches():
    cj, ct = jvgg_cfg.SMOKE, tvgg_cfg.SMOKE
    n = len(cj.plan) + 1                         # through FC1
    feat = JC._w(512, cj.width_mult)
    jb = jsp.Branch(init=lambda k: JC.vgg_init(k, cj)[:n],
                    apply=lambda p, x: JC.vgg_apply(p, cj, x, to_layer=n))
    tb = sp.Branch(init=lambda g: TC.vgg_init(g, ct)[:n],
                   apply=lambda p, x: TC.vgg_apply(p, ct, x, to_layer=n))
    jt = (lambda k: JL.dense_init(k, 2 * feat, cj.n_classes, bias=True),
          JL.dense_apply)
    tt = (lambda g: TL.dense_init(g, 2 * feat, ct.n_classes, bias=True),
          TL.dense_apply)
    return jb, tb, jt, tt, (16, 16, 3), cj.n_classes


BRANCHES = {"mlp": _mlp_branches, "vgg_smoke": _vgg_branches}
WIRES = {"dense": (lambda: [], lambda: []),
         "fake": (lambda: [jquantize_int8()], lambda: [quantize_int8()]),
         "physical": (lambda: [jquantize_int8(physical=True),
                               jleakage_probe()],
                      lambda: [quantize_int8(physical=True),
                               leakage_probe()])}


def _batch(seed, batch, feat_shape, n_classes):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, batch) + feat_shape).astype(np.float32)
    labels = rng.integers(0, n_classes, (batch,))
    return ({"x": jnp.asarray(x), "labels": jnp.asarray(labels, jnp.int32)},
            {"x": torch.from_numpy(x), "labels": torch.from_numpy(labels)})


def _records(wires):
    return [(w.name, tuple(w.shape), str(w.dtype).replace("torch.", ""),
             w.direction, w.bytes, w.physical) for w in wires]


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("net", list(BRANCHES))
def test_vertical_split_grads_match_reference(net, wire):
    jb, tb, jt, tt, feat, ncls = BRANCHES[net]()
    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    pbs_j = [jb.init(keys[0]), jb.init(keys[1])]
    pt_j = jt[0](keys[2])
    pt_j = {"w": pt_j["w"], "b": pt_j["b"] + 0.05}
    bj, bt = _batch(8, 8, feat, ncls)
    jw, tw = WIRES[wire]
    tape_j = JWireTape(JWireStack(jw())) if jw() else []
    tape_t = WireTape(WireStack(tw())) if tw() else []
    loss_j, gb_j, gt_j, _ = jsp.vertical_split_grads(
        [jb, jb], pbs_j, jt[1], pt_j, [bj["x"][0], bj["x"][1]],
        bj["labels"], jsoftmax_xent, tape_j)
    loss_t, gb_t, gt_t, _ = sp.vertical_split_grads(
        [tb, tb], [bridge.tree_from_jax(_np_tree(p)) for p in pbs_j], tt[1],
        bridge.tree_from_jax(_np_tree(pt_j)), [bt["x"][0], bt["x"][1]],
        bt["labels"], softmax_xent, tape_t)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    _assert_trees_close(gt_t, gt_j)
    for a, b in zip(gb_t, gb_j):
        _assert_trees_close(a, b)
    assert _records(tape_t) == _records(tape_j)
    assert [r[0] for r in _records(tape_t)] == [
        "branch_0_act", "branch_1_act", "branch_0_grad", "branch_1_grad"]
    assert all(r[5] == (wire == "physical") for r in _records(tape_t))


def test_no_gradient_flows_through_the_wire():
    """The server differentiates w.r.t. what it RECEIVED: a gradient
    that crosses the fake wire is the quantized server gradient."""
    _, tb, _, tt, _, _ = _mlp_branches()
    g = torch.Generator().manual_seed(0)
    pbs = [tb.init(g), tb.init(g)]
    pt = tt[0](g)
    _, bt = _batch(9, 8, (DIM,), N_CLASSES)
    tape = WireTape(WireStack([quantize_int8()]))
    sp.vertical_split_grads([tb, tb], pbs, tt[1], pt,
                            [bt["x"][0], bt["x"][1]], bt["labels"],
                            softmax_xent, tape)
    assert all(not t.requires_grad for t in tmod.tree_leaves(pbs + [pt]))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_pair(name):
    if name == "adamw_wd":
        return (joptim.adamw(1e-2, weight_decay=0.1),
                optim.adamw(1e-2, weight_decay=0.1))
    if name == "sgd_momentum":
        return joptim.sgd(0.1, momentum=0.9), optim.sgd(0.1, momentum=0.9)
    return joptim.adamw(1e-3), optim.adamw(1e-3)


@pytest.mark.parametrize("name", ["adamw_wd", "adamw", "sgd_momentum"])
def test_optimizer_updates_match_reference(name):
    """Three updates of a tree with a 2-D weight and a 1-D bias: the
    bias is NOT decayed (ndim < 2), as in the reference."""
    jopt, topt = _opt_pair(name)
    pj = {"w": jnp.asarray(_x(10, (3, 4))), "b": jnp.asarray(_x(11, (4,)))}
    pt = bridge.tree_from_jax(_np_tree(pj))
    sj, st = jopt.init(pj), topt.init(pt)
    for i in range(3):
        gj = {"w": jnp.asarray(_x(20 + i, (3, 4))),
              "b": jnp.asarray(_x(30 + i, (4,)))}
        uj, sj = jopt.update(gj, sj, pj)
        ut, st = topt.update(bridge.tree_from_jax(_np_tree(gj)), st, pt)
        _assert_trees_close(ut, uj, dict(rtol=1e-6, atol=1e-7))
        pj, pt = joptim.apply_updates(pj, uj), optim.apply_updates(pt, ut)
    _assert_trees_close(st, sj, dict(rtol=1e-6, atol=1e-7))
    _assert_trees_close(pt, pj, dict(rtol=1e-6, atol=1e-7))
    assert st["step"].dtype == torch.int32 and int(st["step"]) == 3


def test_clip_by_global_norm_matches_reference():
    gj = {"w": jnp.asarray(_x(12, (3, 4), 5.0)), "b": jnp.asarray(_x(13, (4,)))}
    cj, nj = joptim.clip_by_global_norm(gj, 1.0)
    ct, nt = optim.clip_by_global_norm(bridge.tree_from_jax(_np_tree(gj)),
                                       1.0)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    _assert_trees_close(ct, cj, dict(rtol=1e-6, atol=1e-7))


# ---------------------------------------------------------------------------
# Plan(mode="vertical") end to end
# ---------------------------------------------------------------------------

ROUNDS = 3


def _sessions(net, wire, lr=5e-3):
    jb, tb, jt, tt, feat, ncls = BRANCHES[net]()
    jw, tw = WIRES[wire]
    jsess = JPlan(mode="vertical", branch=jb, n_clients=2, trunk=jt,
                  optimizer=joptim.adamw(lr), wire=jw()).compile()
    jsess.init(jax.random.PRNGKey(0))
    tsess = Plan(mode="vertical", branch=tb, n_clients=2, trunk=tt,
                 optimizer=optim.adamw(lr), wire=tw()).compile(device="cpu")
    tsess.state = bridge.tree_from_jax(_np_tree(jsess.state))
    # ROUNDS training batches, then a 64-row evaluation batch: the
    # distance correlation's pairwise distances lose about sqrt(eps)|x|
    # on their zero diagonal in fp32 (the reference's formula), an error
    # that averages out as 1/B, so 8 rows would not hold it to 1e-4
    batches = [_batch(100 + r, 16 if net == "mlp" else 8, feat, ncls)
               for r in range(ROUNDS)] + [_batch(100 + ROUNDS, 64, feat,
                                                 ncls)]
    return jsess, tsess, batches


FIT_CASES = [("mlp", "dense"), ("mlp", "fake"), ("mlp", "physical"),
             ("vgg_smoke", "physical")]


@pytest.fixture(scope="module", params=FIT_CASES,
                ids=[f"{n}-{w}" for n, w in FIT_CASES])
def fitted(request):
    net, wire = request.param
    jsess, tsess, batches = _sessions(net, wire)
    lj = jsess.fit(lambda r: batches[r][0], rounds=ROUNDS)
    lt = tsess.fit(lambda r: batches[r][1], rounds=ROUNDS)
    return net, wire, jsess, tsess, batches, lj, lt


def test_fit_losses_and_state_match_reference(fitted):
    _, _, jsess, tsess, _, lj, lt = fitted
    np.testing.assert_allclose(lt, lj, **TOL)
    assert lt[-1] < lt[0]
    _assert_trees_close(tsess.state, jsess.state)


def test_meter_and_wire_report_match_reference(fitted):
    _, wire, jsess, tsess, batches, _, _ = fitted
    mj, mt = jsess.meter(), tsess.meter()
    assert mt["client_gb"] == mj["client_gb"]
    assert tsess.engine.meter.bytes_up == jsess.engine.meter.bytes_up
    assert tsess.engine.meter.bytes_down == jsess.engine.meter.bytes_down
    rep_t = tsess.wire_report(batches[0][1])
    rep_j = jsess.wire_report(batches[0][0])
    assert rep_t == rep_j
    assert all(r["physical"] == (wire == "physical") for r in rep_t)


def test_evaluate_and_leakage_match_reference(fitted):
    net, wire, jsess, tsess, batches, _, _ = fitted
    ev_j, ev_t = batches[ROUNDS]
    assert float(tsess.evaluate(ev_t)) == float(jsess.evaluate(ev_j))
    np.testing.assert_array_equal(tsess.evaluate_all(ev_t).numpy(),
                                  np.asarray(jsess.evaluate_all(ev_j)))
    for ci in (0, 1):
        rt = tsess.leakage_report(ev_t, client=ci)
        rj = jsess.leakage_report(ev_j, client=ci)
        assert rt.keys() == rj.keys()
        for k in rj:
            np.testing.assert_allclose(rt[k], rj[k], **LEAK_TOL)


def test_flops_ratio_to_xla(fitted):
    net, _, jsess, tsess, _, _, _ = fitted
    ft = tsess.meter()["client_tflops"]
    fj = jsess.meter()["client_tflops"]
    assert ft[0] == ft[1] and fj[0] == fj[1] and fj[0] > 0
    lo, hi = FLOP_RATIO_BAND[net]
    assert lo <= ft[0] / fj[0] <= hi, ft[0] / fj[0]


def test_fused_splitcat_evaluation_matches_concat(fitted):
    """The example's evaluation: the server computes the trunk over both
    branches' features with the fused splitcat entry, no concat."""
    net, _, _, tsess, batches, _, _ = fitted
    _, tb, *_ = BRANCHES[net]()
    ev = batches[ROUNDS][1]
    st = tsess.state
    with torch.no_grad():
        feats = [tb.apply(tree_at(st["clients"], i), ev["x"][i])
                 for i in range(2)]
        logits = ops.splitcat_linear(feats, st["server"]["w"],
                                     st["server"]["b"])
        want = TL.dense_apply(st["server"], torch.cat(feats, -1))
    np.testing.assert_allclose(logits.numpy(), want.numpy(), **TOL)
    acc = float((logits.argmax(-1) == ev["labels"]).float().mean())
    assert acc == float(tsess.evaluate(ev))


def test_clipped_plan_with_server_optimizer_matches_reference():
    """`clip_norm` clips each party's gradient by its global norm and
    `optimizer_server` gives the trunk its own optimizer, as in the
    reference."""
    jb, tb, jt, tt, feat, ncls = _mlp_branches()
    jsess = JPlan(mode="vertical", branch=jb, n_clients=2, trunk=jt,
                  optimizer=joptim.adamw(5e-3),
                  optimizer_server=joptim.sgd(0.1, momentum=0.9),
                  clip_norm=0.05).compile()
    jsess.init(jax.random.PRNGKey(1))
    tsess = Plan(mode="vertical", branch=tb, n_clients=2, trunk=tt,
                 optimizer=optim.adamw(5e-3),
                 optimizer_server=optim.sgd(0.1, momentum=0.9),
                 clip_norm=0.05).compile(device="cpu")
    tsess.state = bridge.tree_from_jax(_np_tree(jsess.state))
    batches = [_batch(200 + r, 16, feat, ncls) for r in range(2)]
    np.testing.assert_allclose(
        tsess.fit(lambda r: batches[r][1], rounds=2),
        jsess.fit(lambda r: batches[r][0], rounds=2), **TOL)
    _assert_trees_close(tsess.state, jsess.state)


def test_step_program_matches_reference():
    jb, tb, jt, tt, _, _ = _mlp_branches()
    pj = jtopo.lower(jtopo.vertical(jb, 3, *jt))
    pt = topo.lower(topo.vertical(tb, 3, *tt))
    assert pt.describe() == pj.describe()
    assert pt.round_type == pj.round_type == "branch"
    for c in range(3):
        assert pt.billed_wires(c) == pj.billed_wires(c)


def test_engine_state_bridges_both_ways():
    _, tsess, _ = _sessions("mlp", "physical")
    back = bridge.tree_from_jax(bridge.tree_to_numpy(tsess.state))
    for a, b in zip(tmod.tree_leaves(back), tmod.tree_leaves(tsess.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert tsess.state["opt_c"]["step"].dtype == torch.int32
    assert tuple(tsess.state["opt_c"]["step"].shape) == (2,)
    assert int(tsess.state["last_trained"]) == -1


def test_distance_correlation_matches_reference():
    x, y = _x(40, (32, 12)), _x(41, (32, 5))
    y[:, 0] += 2 * x[:, 0]
    np.testing.assert_allclose(
        float(privacy.distance_correlation(torch.from_numpy(x),
                                           torch.from_numpy(y))),
        float(jprivacy.distance_correlation(jnp.asarray(x), jnp.asarray(y))),
        **LEAK_TOL)
    stack = WireStack([quantize_int8(), leakage_probe()])
    wire = stack.pre_probe(torch.from_numpy(y))
    assert torch.equal(wire, quantize_int8().apply(torch.from_numpy(y), "", ""))
    assert stack.leakage(torch.from_numpy(x), wire) == float(
        privacy.distance_correlation(torch.from_numpy(x), wire))


def test_unported_modes_and_devices_raise():
    _, tb, _, tt, _, _ = _mlp_branches()
    assert PORTED_MODES == MODES
    # every mode and schedule is ported; microbatches need the pipelined
    # schedule, and a fleet is not ported
    eng = Plan(mode="vertical", branch=tb, trunk=tt, schedule="pipelined",
               microbatches=2).compile(device="cpu").engine
    assert (eng.schedule, eng.microbatches) == ("pipelined", 2)
    with pytest.raises(ValueError, match="requires schedule='pipelined'"):
        Plan(mode="vertical", branch=tb, trunk=tt,
             microbatches=2).compile(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Plan(mode="vertical", branch=tb, trunk=tt,
             fleet=object()).compile(device="cpu")
    assert [t.name for t in parse_wire("quantize_int8:physical,"
                                       "dp_noise:0.1,leakage_probe")] == [
        "quantize_int8", "dp_noise", "leakage_probe"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Plan(mode="vertical", branch=tb, trunk=tt, n_clients=2).compile()


def test_synthetic_batches_are_seeded_and_class_structured():
    g = lambda s: torch.Generator().manual_seed(s)
    a, b = synthetic.image_batch(g(0), 64, 10), synthetic.image_batch(g(0), 64,
                                                                      10)
    assert torch.equal(a["images"], b["images"])
    assert tuple(a["images"].shape) == (64, 32, 32, 3)
    c = synthetic.image_batch(g(1), 64, 10)
    # the class templates are shared across batches: same-class images of
    # two batches are closer than images of different classes
    same = a["labels"][:, None] == c["labels"][None, :]
    d = torch.cdist(a["images"].reshape(64, -1), c["images"].reshape(64, -1))
    assert float(d[same].mean()) < float(d[~same].mean())
    m = synthetic.multimodal_batch(g(2), 16, 4, dim_a=56, dim_b=56)
    assert tuple(m["mod_a"].shape) == (16, 56) and m["labels"].dtype == \
        torch.int64


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_vertical_training_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    _, tsess, batches = _sessions("vgg_smoke", "physical")
    _, tb, _, tt, _, _ = _vgg_branches()
    card = Plan(mode="vertical", branch=tb, n_clients=2, trunk=tt,
                optimizer=optim.adamw(5e-3),
                wire=[quantize_int8(physical=True)]).compile()
    card.state = bridge.tree_from_jax(bridge.tree_to_numpy(tsess.state),
                                      device="cuda")
    lc = card.fit(lambda r: batches[r][1], rounds=ROUNDS)
    lt = tsess.fit(lambda r: batches[r][1], rounds=ROUNDS)
    np.testing.assert_allclose(lc, lt, rtol=1e-4, atol=1e-5)
