"""The training CLI's parts in the port against the JAX reference, on the
CPU: the LR schedules, `dp_noise`, the client partitions,
`assert_no_raw_payload` and the ResNet of the paper's Table 2.

Inputs are seeded numpy arrays handed to both packages; parameters and
engine states come from the JAX side through `repro_torch.bridge`.
Everything is fp32 with TF32 off.  Tolerances, each with its reason:

* schedules: rtol 1e-6 (float32 cos, sqrt and division, each library's
  own rounding);
* `dp_noise` at sigma 0, its key's words (the name's crc32, the payload's
  content hash), the partitions' index arrays given the reference's
  numpy seeds, wire records and metered bytes: BITWISE;
* `dp_noise` at sigma > 0: torch cannot draw JAX's normals, so the noise
  is held to its law: mean and standard deviation within 3 standard
  errors of 0 and sigma;
* ResNet forward and training (SGD with momentum, 2 clients round-robin
  with the p2p handoff, 2 rounds): rtol = atol = 1e-5 (the frameworks sum
  convolutions in other orders).  AdamW is not used: on near-zero
  gradients it parts the frameworks by a whole Adam step
  (`tests/test_torch_vanilla.py`).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.api import Plan as JPlan
from repro.api import dp_noise as jdp_noise
from repro.api import quantize_int8 as jquantize_int8
from repro.api.wire import WireStack as JWireStack
from repro.configs import resnet50_cifar100 as jres_cfg
from repro.core import privacy as jprivacy
from repro.core import split as jsp
from repro.data import partition as jpart
from repro.nn import convnets as JC
from repro.optim import schedules as jsched
from repro_torch import bridge, optim
from repro_torch.api import Plan, WireStack, dp_noise, quantize_int8
from repro_torch.api.wire import content_hash, name_key
from repro_torch.configs import resnet50_cifar100 as tres_cfg
from repro_torch.core import privacy
from repro_torch.core import split as sp
from repro_torch.core.wire_compress import PackedInt8, _fake_quant_int8
from repro_torch.data import partition as part
from repro_torch.nn import convnets as TC
from repro_torch.optim import schedules

TOL = dict(rtol=1e-5, atol=1e-5)
N_CLIENTS, ROUNDS, HW, CUT = 2, 2, 16, 2


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees(t_tree, j_tree, tol=None):
    t_leaves = jax.tree_util.tree_leaves(bridge.tree_to_numpy(t_tree))
    j_leaves = jax.tree_util.tree_leaves(_np_tree(j_tree))
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.shape == b.shape
        if tol is None:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **tol)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

SCHEDULES = {"constant": ((3e-4,), 100),
             "warmup_cosine": ((1e-3, 10, 100), 100),
             "inverse_sqrt": ((1e-3, 10), 100)}


def test_schedules_match_reference():
    for name, (args, total) in SCHEDULES.items():
        steps = np.arange(0, 2 * total + 1, dtype=np.int32)
        fj, ft = getattr(jsched, name)(*args), getattr(schedules, name)(*args)
        want = np.broadcast_to(np.asarray(fj(jnp.asarray(steps))),
                               steps.shape)
        got = ft(torch.from_numpy(steps))
        assert got.dtype == torch.float32 and got.shape == steps.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, err_msg=name)
        # the optimizers' 0-d int32 step, on the state's device
        one = ft(torch.tensor(7, dtype=torch.int32))
        assert one.ndim == 0 and one.dtype == torch.float32
        np.testing.assert_allclose(float(one), float(fj(jnp.int32(7))),
                                   rtol=1e-6)
    assert optim.adam is optim.adamw
    # AdamW reads its lr from the schedule at each step: two steps of a
    # warmup from 0 move the weight by lr(1) + lr(2)'s Adam steps
    opt = optim.adamw(schedules.warmup_cosine(1e-2, 4, 10))
    p = {"w": torch.ones(3)}
    st = opt.init(p)
    for _ in range(2):
        ups, st = opt.update({"w": torch.ones(3)}, st, p)
        p = optim.apply_updates(p, ups)
    np.testing.assert_allclose(p["w"].numpy(), 1 - 2.5e-3 - 5e-3, rtol=1e-5)


# ---------------------------------------------------------------------------
# dp_noise
# ---------------------------------------------------------------------------

def _payload(seed, shape, dtype=np.float32, scale=3.0):
    x = (scale * np.random.default_rng(seed).standard_normal(shape)
         ).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else
                               jnp.float32)
    xt = torch.from_numpy(x)
    return xj, (xt.to(torch.bfloat16) if dtype == "bf16" else xt)


def test_dp_noise_at_sigma_zero_is_the_reference_stack():
    for physical, (shape, dt) in (
            (p, c) for p in (False, True)
            for c in (((4, 8, 16), "f32"), ((2, 3, 64), "bf16"),
                      ((5,), "f32"))):
        js = JWireStack([jquantize_int8(physical=physical), jdp_noise(0.0)])
        ts = WireStack([quantize_int8(physical=physical), dp_noise(0.0)])
        xj, xt = _payload(3, shape, dt)
        oj, ot = js.apply(xj, "cut_act", "up"), ts.apply(xt, "cut_act", "up")
        if physical:
            assert isinstance(ot, PackedInt8)
            np.testing.assert_array_equal(ot.q.numpy(), np.asarray(oj.q))
            np.testing.assert_array_equal(ot.scale.numpy(),
                                          np.asarray(oj.scale))
        else:
            np.testing.assert_array_equal(
                ot.float().numpy(), np.asarray(oj.astype(jnp.float32)))
        # the bytes: the noise changes none, and the handoff skips it
        assert ts.wire_bytes(shape, xt.dtype) == js.wire_bytes(shape,
                                                               xj.dtype)
    tree_j = {"a": jnp.zeros((3, 5)), "b": [jnp.zeros((7,))]}
    tree_t = {"a": torch.zeros(3, 5), "b": [torch.zeros(7)]}
    assert ts.handoff_bytes(tree_t) == js.handoff_bytes(tree_j)
    assert ts.tree_wire_bytes(tree_t) == js.tree_wire_bytes(tree_j)
    assert not dp_noise(0.1).handoff and ts.has_handoff


def test_dp_noise_key_words_match_reference():
    for name in ("cut_act", "cut_grad", "p2p_handoff", "model_pull"):
        assert name_key(name) == zlib.crc32(name.encode()) & 0x7FFFFFFF
    # the content hash: payloads whose bit sums wrap uint32 many times
    for shape, dt, scale in (((64, 256), "f32", 1e30), ((33, 7), "bf16", 3.0),
                             ((4, 512, 96), "f32", 1.0), ((1,), "f32", -2.0)):
        xj, xt = _payload(11, shape, dt, scale)
        bits = jax.lax.bitcast_convert_type(xj.astype(jnp.float32),
                                            jnp.uint32)
        want = int(bits.sum(dtype=jnp.uint32))
        got = content_hash(xt)
        assert got.dtype == torch.int64 and int(got) == want


def test_dp_noise_draws():
    sigma, n = 0.5, 200_000
    stack = WireStack([dp_noise(sigma, seed=3)])
    x = torch.zeros(n // 100, 100)
    noise = stack.apply(x, "cut_act", "up") - x
    se = sigma / np.sqrt(n)
    assert abs(float(noise.mean())) < 3 * se
    assert abs(float(noise.std()) - sigma) < 3 * sigma / np.sqrt(2 * n)
    # the same payload under the same name draws the same noise; another
    # payload, name or seed draws other noise
    again = stack.apply(x, "cut_act", "up") - x
    assert torch.equal(noise, again)
    y = x.clone()
    y[0, 0] = 1.0
    assert not torch.equal(stack.apply(y, "cut_act", "up") - y, noise)
    assert not torch.equal(stack.apply(x, "cut_grad", "down") - x, noise)
    other = WireStack([dp_noise(sigma, seed=4)]).apply(x, "cut_act", "up")
    assert not torch.equal(other - x, noise)
    # downstream of the physical quantizer the noised value is re-packed:
    # int8 on the wire, the bytes of the noiseless payload
    xs = torch.randn(8, 64, generator=torch.Generator().manual_seed(0))
    plain = WireStack([quantize_int8(physical=True)])
    noisy = WireStack([quantize_int8(physical=True), dp_noise(0.1)])
    out = noisy.apply(xs, "cut_act", "up")
    assert isinstance(out, PackedInt8) and out.q.dtype == torch.int8
    assert out.scale.shape == (8, 1)
    ref = plain.apply(xs, "cut_act", "up")
    assert not torch.equal(out.q, ref.q)
    dense = out.q.float() * out.scale
    assert torch.equal(_fake_quant_int8(dense), dense)
    assert noisy.wire_bytes((8, 64), xs.dtype) == 8 * 64 + 8 * 4


# ---------------------------------------------------------------------------
# partitions, structural privacy
# ---------------------------------------------------------------------------

def test_partitions_match_reference():
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 6, 120).astype(np.int32)
    mods = {"mod_a": rng.standard_normal((120, 12)).astype(np.float32),
            "mod_b": rng.standard_normal((120, 12)).astype(np.float32)}
    bj = {"labels": jnp.asarray(labels),
          **{k: jnp.asarray(v) for k, v in mods.items()}}
    bt = {"labels": torch.from_numpy(labels),
          **{k: torch.from_numpy(v) for k, v in mods.items()}}
    for hj, ht in zip(jpart.horizontal_partition(bj, 4),
                      part.horizontal_partition(bt, 4), strict=True):
        _assert_trees(ht, hj)
    for vj, vt in zip(jpart.vertical_partition(bj, ["mod_a", "mod_b"], 1),
                      part.vertical_partition(bt, ["mod_a", "mod_b"], 1),
                      strict=True):
        assert sorted(vj) == sorted(vt)
        _assert_trees(vt, vj)
    _assert_trees(part.vertical_modality_batches(bt, ["mod_a", "mod_b"]),
                  jpart.vertical_modality_batches(bj, ["mod_a", "mod_b"]))
    with pytest.raises(ValueError, match="share one feature shape"):
        part.vertical_modality_batches({**bt, "mod_b": bt["mod_b"][:, :5]},
                                       ["mod_a", "mod_b"])
    # the Dirichlet splits given the reference's numpy seeds, which it
    # draws from jax.random (partition.py:50, 76-78)
    key = jax.random.PRNGKey(7)
    s_alloc = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    s_pick = int(jax.random.randint(jax.random.fold_in(key, 1), (), 0,
                                    2 ** 31 - 1))
    for alpha in (0.1, 0.5, 5.0):
        pj = jpart.dirichlet_label_skew(key, bj["labels"], 5, alpha=alpha)
        pt = part.dirichlet_label_skew(s_alloc, bt["labels"], 5, alpha=alpha)
        assert len(pt) == len(pj) == 5
        for a, b in zip(pt, pj):
            assert a.dtype == torch.int64
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert sum(len(a) for a in pt) == 120
        cj = jpart.dirichlet_client_batches(key, bj, 5, 16, alpha=alpha)
        ct = part.dirichlet_client_batches((s_alloc, s_pick), bt, 5, 16,
                                           alpha=alpha)
        assert ct["mod_a"].shape == (5, 16, 12)
        _assert_trees(ct, cj)
    # from a generator: two seeds drawn in turn, the same shapes
    g = part.dirichlet_client_batches(torch.Generator().manual_seed(1), bt,
                                      3, 8)
    assert g["labels"].shape == (3, 8) and g["mod_b"].shape == (3, 8, 12)


def test_assert_no_raw_payload_matches_reference():
    _, tm, _, _ = _models()
    sess = Plan(mode="vanilla", model=tm, cut=CUT, n_clients=N_CLIENTS,
                wire=[quantize_int8(physical=True)]).compile(device="cpu")
    sess.init(seed=0)
    (bj, bt), = [_batch(1, (N_CLIENTS, 4))]
    wires = list(sess.engine.turn_cost(sess.state, bt).wires)
    raw_t = {"x": bt["x"][0], "labels": bt["labels"][0]}
    raw_j = {"x": bj["x"][0], "labels": bj["labels"][0]}
    assert privacy.assert_no_raw_payload(wires, raw_t) == []
    # a record shaped like the raw input (a cut at 0) is flagged, as the
    # reference flags it
    leak = sp.WireRecord("cut_act", tuple(raw_t["x"].shape), torch.float32,
                         "up")
    leak_j = jsp.WireRecord("cut_act", tuple(raw_j["x"].shape), jnp.float32,
                            "up")
    got = privacy.assert_no_raw_payload(wires + [leak], raw_t)
    assert got == [("cut_act", "x")] == jprivacy.assert_no_raw_payload(
        [leak_j], raw_j)


# ---------------------------------------------------------------------------
# ResNet (configs/resnet50_cifar100.py)
# ---------------------------------------------------------------------------

def _models(cfg_j=jres_cfg.SMOKE, cfg_t=tres_cfg.SMOKE):
    plan_j, plan_t = JC.resnet_plan(cfg_j), TC.resnet_plan(cfg_t)
    assert plan_j == plan_t
    jm = jsp.list_segmodel(
        len(plan_j), lambda k: JC.resnet_init(k, cfg_j),
        lambda p, i, x: JC.resnet_apply([None] * i + [p], cfg_j, x,
                                        from_layer=i, to_layer=i + 1))
    tm = sp.list_segmodel(
        len(plan_t), lambda g: TC.resnet_init(g, cfg_t),
        lambda p, i, x: TC.resnet_layer_apply(p, plan_t[i], x))
    return jm, tm, plan_t, cfg_t


def _batch(seed, lead, n_classes=4, hw=HW):
    """{"x": lead + (hw, hw, 3), "labels": lead} in both packages, the
    recipe of `data/synthetic.py:image_batch`."""
    rng = np.random.default_rng(seed)
    templates = np.random.default_rng(1234).standard_normal(
        (n_classes, hw, hw, 3))
    labels = rng.integers(0, n_classes, lead)
    x = (templates[labels] + 0.6 * rng.standard_normal(
        lead + (hw, hw, 3))).astype(np.float32)
    return ({"x": jnp.asarray(x), "labels": jnp.asarray(labels, jnp.int32)},
            {"x": torch.from_numpy(x), "labels": torch.from_numpy(labels)})


def test_resnet_apply_matches_reference():
    """The whole net and each layer alone, at an even size (the stride-2
    3x3 convs pad (0, 1), as XLA's SAME does) and an odd one (1, 1); the
    SMOKE config's second stage opens with a stride-2 block and its 1x1
    projection, and CONFIG's plan is the paper's (3, 4, 6, 3) stages."""
    cfg = jres_cfg.SMOKE
    pj = JC.resnet_init(jax.random.PRNGKey(2), cfg)
    pj = jax.tree_util.tree_map(lambda a: a + 0.05 if a.ndim == 1 else a, pj)
    pt = bridge.tree_from_jax(_np_tree(pj))
    plan = TC.resnet_plan(tres_cfg.SMOKE)
    assert plan == [("stem", 1), ("block", 1), ("block", 2), ("head", 1)]
    assert "proj" in pt[2] and "proj" not in pt[1]
    assert TC.resnet_plan(tres_cfg.CONFIG) == JC.resnet_plan(jres_cfg.CONFIG)
    for hw in (16, 15):
        xj, xt = _batch(3, (3,), hw=hw)
        np.testing.assert_allclose(
            TC.resnet_apply(pt, tres_cfg.SMOKE, xt["x"]).numpy(),
            np.asarray(JC.resnet_apply(pj, cfg, xj["x"])), **TOL)
        hj, ht = xj["x"], xt["x"]
        for i in range(len(plan)):
            hj = JC.resnet_apply(pj, cfg, hj, from_layer=i, to_layer=i + 1)
            ht = TC.resnet_apply(pt, tres_cfg.SMOKE, ht, from_layer=i,
                                 to_layer=i + 1)
            assert tuple(ht.shape) == hj.shape
            np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
    # the parameter trees: the same leaves, shapes and dtypes
    lt = jax.tree_util.tree_leaves(bridge.tree_to_numpy(
        TC.resnet_init(torch.Generator().manual_seed(0), tres_cfg.CONFIG)))
    lj = jax.tree_util.tree_leaves(jax.eval_shape(
        lambda: JC.resnet_init(jax.random.PRNGKey(0), jres_cfg.CONFIG)))
    assert [(a.shape, a.dtype) for a in lt] == [(b.shape, b.dtype)
                                                for b in lj]


def test_resnet_vanilla_training_matches_reference():
    """SMOKE ResNet cut 2 (client: the stem and the first block; server:
    the stride-2 block with its projection and the head), 2 clients
    round-robin with the p2p handoff over the physical wire with dp_noise
    at sigma 0, 2 rounds of SGD with momentum: losses and states, the
    meter and the wire report; then the same with sigma 0.05, whose
    metered bytes are the reference's."""
    jm, tm, _, _ = _models()

    def sessions(sigma):
        jsess = JPlan(mode="vanilla", model=jm, cut=CUT, n_clients=N_CLIENTS,
                      optimizer=joptim.sgd(0.05, 0.9),
                      wire=[jquantize_int8(physical=True),
                            jdp_noise(sigma)]).compile()
        jsess.init(jax.random.PRNGKey(0))
        tsess = Plan(mode="vanilla", model=tm, cut=CUT, n_clients=N_CLIENTS,
                     optimizer=optim.sgd(0.05, 0.9),
                     wire=[quantize_int8(physical=True), dp_noise(sigma)]
                     ).compile(device="cpu")
        tsess.state = bridge.tree_from_jax(_np_tree(jsess.state))
        return jsess, tsess

    batches = [_batch(100 + r, (N_CLIENTS, 8)) for r in range(ROUNDS)]
    jsess, tsess = sessions(0.0)
    lj = [np.asarray(jsess.run_round(b[0])) for b in batches]
    lt = [tsess.run_round(b[1]).numpy() for b in batches]
    np.testing.assert_allclose(np.stack(lt), np.stack(lj), **TOL)
    _assert_trees(tsess.state, jsess.state, TOL)
    assert tsess.wire_report(batches[0][1]) == jsess.wire_report(
        batches[0][0])
    cut = 8 * HW * HW * 8 + 8 * HW * HW * 4
    assert [r["bytes"] for r in tsess.wire_report(batches[0][1])] == [cut,
                                                                      cut]
    assert tsess.meter()["client_gb"] == jsess.meter()["client_gb"]
    ev_j, ev_t = _batch(200, (32,))
    np.testing.assert_allclose(tsess.evaluate_all(ev_t).numpy(),
                               np.asarray(jsess.evaluate_all(ev_j)),
                               **TOL)

    jsess, tsess = sessions(0.05)
    for b in batches:
        jsess.run_round(b[0])
        tsess.run_round(b[1])
    for name in ("bytes_up", "bytes_down", "sync_bytes"):
        assert getattr(tsess.engine.meter, name) == getattr(
            jsess.engine.meter, name)
    assert tsess.meter()["client_gb"] == jsess.meter()["client_gb"]
