"""The port's deprecated trainer shims (`core/protocol.py`,
`core/baselines.py`) and the paper's Tables 1-2 and Fig. 3
(`launch/paper_tables.py`) against the JAX reference, on the CPU.

The model is the smoke VGG (`configs/vgg_cifar10.py:SMOKE`), 3 clients
of 8 rows, 2 rounds; inputs are seeded numpy arrays handed to both
packages and the port's initial state is the reference's, through
`repro_torch.bridge`.  Everything is fp32 with TF32 off.  Tolerances,
each with its reason:

* metered bytes, the analytic tables' rows (to 1e-12 relative) and the
  shim's engine against the port's own `Plan`: exactly equal (the shim
  runs that engine);
* losses, states and the eager backend against the engine: rtol = atol =
  1e-5, as in `tests/test_torch_vanilla.py` and
  `tests/test_torch_baselines.py` (the two frameworks sum convolutions
  in different orders; the eager loop and the engine in the same order,
  but the tolerance is the stated fp32 one).  FedAvg runs SGD with
  momentum, as the baselines' dense-wire case does: under AdamW a few of
  conv 1's weights, whose gradients nearly cancel, drift apart;
* FLOPs: torch's counter over XLA's cost model in
  `tests/test_torch_vanilla.py:FLOP_RATIO_BAND`.
"""
import importlib.util
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import vgg_cifar10 as jvgg_cfg
from repro.core import baselines as jbl
from repro.core import protocol as jpr
from repro.core import split as jsp
from repro.nn import convnets as JC
from repro_torch import bridge, optim
from repro_torch.api import Plan, softmax_xent
from repro_torch.configs import vgg_cifar10 as tvgg_cfg
from repro_torch.core import baselines as bl
from repro_torch.core import protocol as pr
from repro_torch.core import split as sp
from repro_torch.engine import (copy_tree, stack_state, stack_trees,
                                tree_index, unstack_state)
from repro_torch.launch import paper_tables as pt
from repro_torch.nn import convnets as TC
from repro_torch.nn import module as tmod
from _torch_threads import one_torch_thread

one_torch_thread()

TOL = dict(rtol=1e-5, atol=1e-5)
FLOP_RATIO_BAND = (1.02, 1.03)
N_CLIENTS, ROWS, ROUNDS, HW, N_CLS, CUT, CUTS = 3, 8, 2, 32, 4, 2, (2, 5)
SHIMS = ("split_p2p", "split_none", "u_shaped", "fedavg", "large_batch")


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ce(logits, labels):
    lp = jax.nn.log_softmax(logits)
    return -jnp.take_along_axis(lp, labels[:, None], 1).mean()


def _segmodels():
    cj, ct = jvgg_cfg.SMOKE, tvgg_cfg.SMOKE
    plan_j, plan_t = JC.vgg_plan(cj), TC.vgg_plan(ct)
    jm = jsp.list_segmodel(len(plan_j), lambda k: JC.vgg_init(k, cj),
                           lambda p, i, x: JC.vgg_layer_apply(p, plan_j[i], x))
    tm = sp.list_segmodel(len(plan_t), lambda g: TC.vgg_init(g, ct),
                          lambda p, i, x: TC.vgg_layer_apply(p, plan_t[i], x))
    return jm, tm


def _full(cfg, conv):
    return dict(init_fn=lambda k: conv.vgg_init(k, cfg),
                apply_fn=lambda p, x: conv.vgg_apply(p, cfg, x))


def _shims(kind, backend="engine"):
    """(reference shim, port shim) of one kind, warnings silenced."""
    jm, tm = _segmodels()
    sgd = kind == "fedavg"
    jo = (lambda: joptim.sgd(0.05, 0.9)) if sgd else (
        lambda: joptim.adamw(1e-3))
    to = (lambda: optim.sgd(0.05, 0.9)) if sgd else (
        lambda: optim.adamw(1e-3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if kind.startswith("split"):
            sync = kind.split("_")[1]
            return (jpr.SplitTrainer(
                        model=jm, cut=CUT, loss_fn=_ce,
                        optimizer_client=jo(), optimizer_server=jo(),
                        n_clients=N_CLIENTS, sync=sync, backend=backend),
                    pr.SplitTrainer(
                        model=tm, cut=CUT, loss_fn=softmax_xent,
                        optimizer_client=to(), optimizer_server=to(),
                        n_clients=N_CLIENTS, sync=sync, backend=backend,
                        device="cpu"))
        if kind == "u_shaped":
            return (jpr.UShapedTrainer(model=jm, cut1=CUTS[0], cut2=CUTS[1],
                                       loss_fn=_ce, optimizer=jo(),
                                       n_clients=N_CLIENTS),
                    pr.UShapedTrainer(model=tm, cut1=CUTS[0], cut2=CUTS[1],
                                      loss_fn=softmax_xent, optimizer=to(),
                                      n_clients=N_CLIENTS, device="cpu"))
        jcls, tcls = ((jbl.FedAvgTrainer, bl.FedAvgTrainer)
                      if kind == "fedavg" else
                      (jbl.LargeBatchSGDTrainer, bl.LargeBatchSGDTrainer))
        return (jcls(loss_fn=_ce, optimizer=jo(), n_clients=N_CLIENTS,
                     backend=backend, **_full(jvgg_cfg.SMOKE, JC)),
                tcls(loss_fn=softmax_xent, optimizer=to(),
                     n_clients=N_CLIENTS, backend=backend, device="cpu",
                     **_full(tvgg_cfg.SMOKE, TC)))


def _state_from_jax(jstate):
    """The reference shim's state as the port's: tensors, with an int
    `last_trained` where the state has one."""
    rest = {k: v for k, v in jstate.items() if k != "last_trained"}
    out = bridge.tree_from_jax(_np_tree(rest))
    if "last_trained" in jstate:
        out["last_trained"] = int(jstate["last_trained"])
    return out


def _shards(seed, rows=(ROWS,) * N_CLIENTS):
    """Per-client batches, a fixed template per class plus 0.6 noise
    (`data/synthetic.py:image_batch`'s recipe), for both packages."""
    rng = np.random.default_rng(seed)
    templates = np.random.default_rng(1234).standard_normal(
        (N_CLS, HW, HW, 3))
    js, ts = [], []
    for n in rows:
        labels = rng.integers(0, N_CLS, n)
        x = (templates[labels] + 0.6 * rng.standard_normal(
            (n, HW, HW, 3))).astype(np.float32)
        js.append({"x": jnp.asarray(x),
                   "labels": jnp.asarray(labels, jnp.int32)})
        ts.append({"x": torch.from_numpy(x),
                   "labels": torch.from_numpy(labels)})
    return js, ts


def _step(shim, state, shards):
    if isinstance(shim, (jbl.LargeBatchSGDTrainer, bl.LargeBatchSGDTrainer)):
        return shim.train_step(state, shards)
    return shim.train_round(state, shards)


def _assert_trees(t_tree, j_tree, tol=None):
    t_np = bridge.tree_to_numpy(t_tree)
    j_np = _np_tree(j_tree)
    assert jax.tree_util.tree_structure(t_np) == \
        jax.tree_util.tree_structure(j_np)
    for a, b in zip(jax.tree_util.tree_leaves(t_np),
                    jax.tree_util.tree_leaves(j_np)):
        assert a.shape == b.shape
        if tol is None:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **tol)


def _no_last(state):
    return {k: v for k, v in state.items() if k != "last_trained"}


def _meters_equal(a, b):
    for name in ("flops", "bytes_up", "bytes_down", "sync_bytes"):
        assert getattr(a, name) == getattr(b, name), name


# ---------------------------------------------------------------------------
# each shim against the reference's, 2 rounds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=SHIMS)
def trained(request):
    kind = request.param
    jshim, tshim = _shims(kind)
    jst = jshim.init(jax.random.PRNGKey(0))
    tst = _state_from_jax(jst)
    lj, lt = [], []
    for r in range(ROUNDS):
        js, ts = _shards(100 + r)
        jst, loss_j = _step(jshim, jst, js)
        tst, loss_t = _step(tshim, tst, ts)
        lj.append(float(loss_j))
        lt.append(float(loss_t))
    return kind, jshim, tshim, jst, tst, lj, lt


def test_shim_losses_and_state_match_reference(trained):
    kind, _, _, jst, tst, lj, lt = trained
    np.testing.assert_allclose(lt, lj, **TOL)
    _assert_trees(_no_last(tst), _no_last(jst), TOL)
    if "last_trained" in jst:
        assert tst["last_trained"] == int(jst["last_trained"])


def test_shim_meter_matches_reference(trained):
    kind, jshim, tshim, _, _, _, _ = trained
    for name in ("bytes_up", "bytes_down", "sync_bytes"):
        assert getattr(tshim.meter, name) == getattr(jshim.meter, name)
    if kind == "split_p2p":     # client 0 is one handoff short
        assert 0 < tshim.meter.sync_bytes[0] < tshim.meter.sync_bytes[1]
    ft, fj = tshim.meter.flops, jshim.meter.flops
    if kind == "u_shaped":      # its topology bills no client forward
        assert ft == fj == [0.0] * N_CLIENTS
        return
    assert len(set(ft)) == 1 and fj[0] > 0
    lo, hi = FLOP_RATIO_BAND
    assert lo <= ft[0] / fj[0] <= hi, ft[0] / fj[0]


def test_shim_evaluate_matches_reference(trained):
    kind, jshim, tshim, jst, tst, _, _ = trained
    if kind == "u_shaped":      # the reference's u-shaped shim has none
        return
    (ej,), (et,) = _shards(999, rows=(64,))
    acc = tshim.evaluate(tst, et)
    assert acc.ndim == 0
    assert float(acc) == float(jshim.evaluate(jst, ej))


# ---------------------------------------------------------------------------
# the shim's engine is the port's Plan, bitwise
# ---------------------------------------------------------------------------

def _plan(kind, tshim):
    _, tm = _segmodels()
    if kind.startswith("split"):
        return Plan(mode="vanilla", model=tm, cut=CUT, loss_fn=softmax_xent,
                    optimizer=tshim.optimizer_client,
                    optimizer_server=tshim.optimizer_server,
                    n_clients=N_CLIENTS, sync=tshim.sync)
    if kind == "u_shaped":
        return Plan(mode="u_shaped", model=tm, cuts=CUTS,
                    loss_fn=softmax_xent, optimizer=tshim.optimizer,
                    n_clients=N_CLIENTS, sync="none")
    return Plan(mode=kind, model=tm, loss_fn=softmax_xent,
                optimizer=tshim.optimizer, n_clients=N_CLIENTS)


def _engine_state(kind, state):
    if kind.startswith("split"):
        return stack_state(state, N_CLIENTS)
    if kind == "u_shaped":
        return {"clients": stack_trees(state["clients"]),
                "server": copy_tree(state["server"]),
                "opt_c": stack_trees(state["opt"]["clients"]),
                "opt_s": copy_tree(state["opt"]["server"]),
                "last_trained": torch.tensor(-1, dtype=torch.int32)}
    if kind == "fedavg":
        return {"global": copy_tree(state["global"]),
                "opt": stack_trees(state["opt"])}
    return copy_tree(state)


@pytest.mark.parametrize("kind", SHIMS)
def test_engine_shim_bitwise_equals_plan(kind):
    """The reference's `tests/test_api.py:143-197`, over the port: the
    shim and `Plan(...).compile("cpu")` from one state, 2 rounds, give
    the same bits and the same meter."""
    _, tshim = _shims(kind)
    tst = tshim.init(seed=3)
    sess = _plan(kind, tshim).compile(device="cpu")
    sess.state = _engine_state(kind, tst)
    for r in range(ROUNDS):
        _, ts = _shards(200 + r)
        tst, loss = _step(tshim, tst, ts)
        want = sess.run_round(ts).mean()
        assert torch.equal(loss, want)
    got = _engine_state(kind, tst)
    for key in ("clients", "server", "opt_c", "opt_s", "global", "opt"):
        if key in got:
            a, b = tmod.tree_leaves(got[key]), tmod.tree_leaves(
                sess.state[key])
            assert len(a) == len(b) and all(torch.equal(x, y)
                                            for x, y in zip(a, b)), key
    assert tshim.meter is tshim.engine.meter
    _meters_equal(tshim.meter, sess.engine.meter)


def test_shim_init_is_the_plan_session_init():
    """A shim seeded like `Session.init` draws the same parameters."""
    _, tshim = _shims("split_p2p")
    st = tshim.init(seed=5)
    sess = _plan("split_p2p", tshim).compile(device="cpu")
    sess.init(seed=5)
    for a, b in zip(tmod.tree_leaves(stack_state(st, N_CLIENTS)["clients"]),
                    tmod.tree_leaves(sess.state["clients"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the eager backends and ragged batches
# ---------------------------------------------------------------------------

EAGER = ("split_p2p", "split_none", "fedavg", "large_batch")


@pytest.mark.parametrize("kind", EAGER)
def test_eager_backend_equals_engine(kind):
    """The reference's per-client loop over `vanilla_split_grads` (the
    baselines' full-model loops) against the engine, from one state: the
    losses and states within the fp32 tolerance, the meters exactly."""
    (_, eng), (_, eag) = _shims(kind), _shims(kind, backend="eager")
    st = eng.init(seed=4)
    st_e = copy_tree(_no_last(st))
    if "last_trained" in st:
        st_e["last_trained"] = st["last_trained"]
    for r in range(ROUNDS):
        _, ts = _shards(300 + r)
        st, loss = _step(eng, st, ts)
        st_e, loss_e = _step(eag, st_e, ts)
        np.testing.assert_allclose(float(loss_e), float(loss), **TOL)
    for a, b in zip(tmod.tree_leaves(_no_last(st_e)),
                    tmod.tree_leaves(_no_last(st))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    assert eag._engine is None
    _meters_equal(eag.meter, eng.meter)


def test_ragged_batch_takes_the_eager_path():
    """Per-client batches of unequal rows cannot stack: the engine shim
    runs the eager loop (no engine is built), bitwise the eager
    backend's, meter included."""
    _, tshim = _shims("split_p2p")
    _, eager = _shims("split_p2p", backend="eager")
    tst = tshim.init(seed=1)
    st_e = {**copy_tree(_no_last(tst)), "last_trained": -1}
    _, ts = _shards(400, rows=(ROWS, ROWS, 5))
    assert pr._ragged(ts) and not pr._ragged(_shards(400)[1])
    for _ in range(ROUNDS):
        tst, lt = tshim.train_round(tst, ts)
        st_e, le = eager.train_round(st_e, ts)
        assert torch.equal(lt, le)
    assert tshim._engine is None
    assert tst["last_trained"] == st_e["last_trained"] == N_CLIENTS - 1
    assert all(torch.equal(a, b) for a, b in zip(
        tmod.tree_leaves(_no_last(tst)), tmod.tree_leaves(_no_last(st_e))))
    _meters_equal(tshim.meter, eager.meter)
    assert tshim.meter.sync_bytes[0] > 0       # round 2's handoff to 0


@pytest.mark.parametrize("kind", ("split_p2p", "u_shaped", "fedavg",
                                  "large_batch"))
def test_shims_warn_deprecation_naming_the_plan(kind):
    with pytest.warns(DeprecationWarning, match=r"repro_torch\.api\.Plan"):
        with warnings.catch_warnings():
            warnings.simplefilter("always", DeprecationWarning)
            cls = {"split_p2p": pr.SplitTrainer,
                   "u_shaped": pr.UShapedTrainer,
                   "fedavg": bl.FedAvgTrainer,
                   "large_batch": bl.LargeBatchSGDTrainer}[kind]
            _, tm = _segmodels()
            kw = {"split_p2p": dict(model=tm, cut=CUT,
                                    optimizer_client=optim.sgd(0.1),
                                    optimizer_server=optim.sgd(0.1)),
                  "u_shaped": dict(model=tm, cut1=2, cut2=5,
                                   optimizer=optim.sgd(0.1))}.get(
                kind, dict(optimizer=optim.sgd(0.1),
                           **_full(tvgg_cfg.SMOKE, TC)))
            cls(loss_fn=softmax_xent, n_clients=2, device="cpu", **kw)


def test_tree_mean_and_state_helpers():
    trees = [[{"w": torch.full((2,), float(k))}] for k in range(3)]
    assert torch.equal(bl.tree_mean(trees)[0]["w"], torch.ones(2))
    _, tshim = _shims("split_p2p")
    st = tshim.init(seed=0)
    est = stack_state(st, N_CLIENTS)
    assert est["last_trained"].dtype == torch.int32
    back = unstack_state(est, N_CLIENTS)
    assert back["last_trained"] == -1
    for a, b in zip(tmod.tree_leaves(back["clients"]),
                    tmod.tree_leaves(st["clients"])):
        assert torch.equal(a, b)
    one = tree_index(est["clients"], torch.tensor(1))
    assert all(torch.equal(a, b) for a, b in zip(
        tmod.tree_leaves(one), tmod.tree_leaves(st["clients"][1])))


# ---------------------------------------------------------------------------
# the paper's tables and figure
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_tables():
    """The reference's `benchmarks/paper_tables.py` as a module."""
    path = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / \
        "paper_tables.py"
    spec = importlib.util.spec_from_file_location("_ref_paper_tables", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tables_match_reference(ref_tables):
    for mine, ref in ((pt.table1_rows(), ref_tables.table1_rows()),
                      (pt.table2_rows(), ref_tables.table2_rows())):
        assert [r[:2] for r in mine] == [r[:2] for r in ref]
        np.testing.assert_allclose([r[2] for r in mine],
                                   [r[2] for r in ref], rtol=1e-12, atol=0)


def test_fig3_on_the_cpu_against_reference(ref_tables):
    """5 rounds: one point a method, labelled as the reference labels
    them; each method's client TFLOPs in the FLOP band of the
    reference's; splitNN's below the full-model methods', fedavg's
    equal to large_batch's (`tests/test_protocol.py:76-107`)."""
    mine = pt.fig3_accuracy_vs_flops(rounds=5, device="cpu")
    ref = ref_tables.fig3_accuracy_vs_flops(rounds=5)
    assert [m for m, _, _ in mine] == [m for m, _, _ in ref] == [
        "splitnn", "federated", "large_batch"]
    lo, hi = FLOP_RATIO_BAND
    for (_, ft, acc), (_, fj, _) in zip(mine, ref):
        assert lo <= ft / fj <= hi, ft / fj
        assert 0.0 <= acc <= 1.0
    f = {m: t for m, t, _ in mine}
    assert f["splitnn"] < f["federated"] and f["splitnn"] < f["large_batch"]
    assert abs(f["federated"] - f["large_batch"]) / f["federated"] < 1e-6
    if not torch.cuda.is_available():   # the GPU unless told otherwise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.fig3_accuracy_vs_flops(rounds=1)
