"""The port's fleet (`Plan(fleet=FleetSpec(...))`: the clients sharded
over the ranks of a process group) on the CPU, over gloo.

* One rank (a group of one, made in this process): every mode of
  `tests/test_fleet.py:ALL_MODES`, the parallel schedule and a physical
  int8 stack with the p2p handoff, over that file's tiny VGG and dense
  branches, with seeded numpy data for both packages and the reference's
  initial state bridged in.  The fleet is held BITWISE to the port's
  single-device `Session` (losses, state, meters, `wire_report`,
  `evaluate`, `evaluate_all`), and to the reference's single-device
  `Session` at the tolerances of `tests/test_torch_{modes,baselines}.py`:
  rtol = atol = 1e-5 for losses and states, accuracies and wire records
  exactly.  As there, the dense fedavg case runs SGD with momentum (AdamW
  drifts the frameworks apart where two moments nearly cancel) and the
  rest AdamW(1e-3).
* Two and four ranks, each a process of `tests/_torch_fleet_ranks.py`
  (one spawn per rank count, started when the module's first test runs,
  so they train while the one-rank cases do): the round-robin turn kinds
  over the physical wire, vanilla over the dense wire without the
  handoff, the parallel schedule, fedavg, large_batch and the vertical
  branch kind, against the same cases on one device in this process at
  rtol = 1e-5, atol = 1e-6 (`tests/test_fleet.py:assert_tree_equal`'s);
  meters, wire reports and accuracies exactly; every rank's gathered
  state the same; each ring hop moving exactly `handoff_bytes` (the int8
  q and row scales); the wire kernels' plain versions called as often,
  summed over the ranks, as on one device.  Everything runs one torch
  thread a process (the round-robin cases then come out bitwise).
* Validation, the mesh factory's messages, the pipelined and monolithic
  refusals, `dirichlet_client_batches` feeding the engine, the
  collectives' device check, the checkpoints, and the CLI's `--fleet`.
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.nn.layers as JL
from repro import optim as joptim
from repro.api import Plan as JPlan
from repro.api import quantize_int8 as jquantize_int8
from repro.core import split as jsp
from repro.nn import convnets as JC
from repro_torch import bridge, optim
from repro_torch.api import FleetSpec, Plan, quantize_int8, softmax_xent
from repro_torch.checkpoint import restore_state, save_state
from repro_torch.core import split as sp
from repro_torch.data import partition
from repro_torch.engine import FleetRoundEngine, tree_at
from repro_torch.engine import topology as topo
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train
from repro_torch.nn import convnets as TC
from repro_torch.nn import dist as tdist
from repro_torch.nn import layers as TL
from repro_torch.nn.module import tree_leaves

import _torch_fleet_ranks as ranks
from _torch_threads import one_torch_thread

one_torch_thread()

TOL = dict(rtol=1e-5, atol=1e-5)          # against the reference
RANK_TOL = dict(rtol=1e-5, atol=1e-6)     # D ranks against one device
N_CLS, HW, ROWS, N_CLIENTS, ROUNDS, DIM = 4, 32, 8, 2, 2, 64
ALL_MODES = ("vanilla", "u_shaped", "vertical", "multihop", "multitask",
             "extended_vanilla", "fedavg", "large_batch")
ONE_RANK_CASES = ALL_MODES + ("parallel", "physical")
WORLDS = (2, 4)


# ---------------------------------------------------------------------------
# the reference test's models (tests/test_fleet.py:33-116) in both packages
# ---------------------------------------------------------------------------

def _cfgs():
    kw = dict(name="t", width_mult=0.25, plan=(16, 16, "M", 32, "M"),
              n_classes=N_CLS)
    return JC.CNNConfig(**kw), TC.CNNConfig(**kw)


def _models():
    cj, ct = _cfgs()
    pj, pt = JC.vgg_plan(cj), TC.vgg_plan(ct)
    return (jsp.list_segmodel(len(pj), lambda k: JC.vgg_init(k, cj),
                              lambda p, i, x: JC.vgg_layer_apply(p, pj[i], x)),
            sp.list_segmodel(len(pt), lambda g: TC.vgg_init(g, ct),
                             lambda p, i, x: TC.vgg_layer_apply(p, pt[i], x)))


def _dense(k_in, k_out):
    return ((lambda k: {"w": JL.dense_init(k, k_in, k_out, bias=True)},
             lambda p, f: JL.dense_apply(p["w"], f)),
            (lambda g: {"w": TL.dense_init(g, k_in, k_out, bias=True)},
             lambda p, f: TL.dense_apply(p["w"], f)))


def _branches():
    jb = jsp.Branch(init=lambda k: {"w": JL.dense_init(k, DIM, 16,
                                                       bias=True)},
                    apply=lambda p, x: jax.nn.relu(JL.dense_apply(p["w"], x)))
    tb = sp.Branch(init=lambda g: {"w": TL.dense_init(g, DIM, 16, bias=True)},
                   apply=lambda p, x: torch.relu(TL.dense_apply(p["w"], x)))
    return jb, tb


def _plan_kwargs(case: str):
    """(reference Plan keywords, port Plan keywords) of a one-rank case:
    `tests/test_fleet.py:plan_kwargs`'s, over 2 clients."""
    mode = {"parallel": "vanilla", "physical": "vanilla"}.get(case, case)
    sgd = case == "fedavg"
    jopt, topt = ((joptim.sgd(0.05, 0.9), optim.sgd(0.05, 0.9)) if sgd
                  else (joptim.adamw(1e-3), optim.adamw(1e-3)))
    jkw = dict(mode=mode, optimizer=jopt, n_clients=N_CLIENTS)
    tkw = dict(mode=mode, optimizer=topt, n_clients=N_CLIENTS)
    if case == "parallel":
        jkw["schedule"] = tkw["schedule"] = "parallel"
    if case == "physical":
        jkw["wire"] = (jquantize_int8(physical=True),)
        tkw["wire"] = (quantize_int8(physical=True),)
    if mode in ("vanilla", "u_shaped", "multihop", "fedavg", "large_batch"):
        jm, tm = _models()
        extra = {"vanilla": dict(cut=2), "u_shaped": dict(cuts=(1, 4)),
                 "multihop": dict(cuts=[1, 3]),
                 "fedavg": dict(local_steps=2)}.get(mode, {})
        return dict(jkw, model=jm, **extra), dict(tkw, model=tm, **extra)
    jb, tb = _branches()
    (jh, th), (jmid, tmid) = _dense(32, N_CLS), _dense(32, 24)
    jtr, ttr = _dense(24, N_CLS)
    if mode == "vertical":
        jx, tx = dict(trunk=jh), dict(trunk=th)
    elif mode == "multitask":
        jx, tx = dict(heads=(jh, jh)), dict(heads=(th, th))
    else:
        jx, tx = dict(mid=jmid, trunk=jtr), dict(mid=tmid, trunk=ttr)
    return dict(jkw, branch=jb, **jx), dict(tkw, branch=tb, **tx)


def _round_data(case: str, r: int):
    """Round r's batches as (reference's, port's): 2 clients of 8 images,
    or 2 modalities of 16 rows (per-task labels for multitask)."""
    rng = np.random.default_rng(100 + r)
    if case in ("vertical", "multitask", "extended_vanilla"):
        w = np.random.default_rng(77).standard_normal((2, N_CLS, DIM))
        labels = rng.integers(0, N_CLS, (16,))
        x = (w[:, labels] + 0.5 * rng.standard_normal((2, 16, DIM))
             ).astype(np.float32)
        if case == "multitask":
            labels = np.stack([labels, (labels + 1) % N_CLS])
        return ({"x": jax.numpy.asarray(x),
                 "labels": jax.numpy.asarray(labels, jax.numpy.int32)},
                {"x": torch.from_numpy(x), "labels": torch.from_numpy(labels)})
    templates = np.random.default_rng(1234).standard_normal(
        (N_CLS, HW, HW, 3))
    labels = rng.integers(0, N_CLS, (N_CLIENTS, ROWS))
    x = (templates[labels] + 0.6 * rng.standard_normal(
        (N_CLIENTS, ROWS, HW, HW, 3))).astype(np.float32)
    return ([{"x": jax.numpy.asarray(x[i]),
              "labels": jax.numpy.asarray(labels[i], jax.numpy.int32)}
             for i in range(N_CLIENTS)],
            [{"x": torch.from_numpy(x[i]), "labels": torch.from_numpy(labels[i])}
             for i in range(N_CLIENTS)])


def _eval_batch(case: str):
    j, t = _round_data(case, 50)
    return (j, t) if isinstance(t, dict) else (j[0], t[0])


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# one rank: bitwise the port's single device, close to the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ONE_RANK_CASES)
def one_rank(request):
    """The case trained ROUNDS rounds by the reference's Session, the
    port's single-device Session and the port's one-rank fleet, from the
    reference's initial state."""
    case = request.param
    jkw, tkw = _plan_kwargs(case)
    jsess = JPlan(**jkw).compile()
    jsess.init(jax.random.PRNGKey(0))
    init = bridge.tree_from_jax(_np_tree(jsess.state))
    plain = Plan(**tkw).compile(device="cpu")
    fleet = Plan(fleet=FleetSpec(n_devices=1), **tkw).compile(device="cpu")
    plain.state = bridge.tree_from_jax(_np_tree(jsess.state))
    fleet.load_state(init)
    data = [_round_data(case, r) for r in range(ROUNDS)]
    lj = np.stack([np.asarray(jsess.run_round(d[0])) for d in data])
    lp = torch.stack([plain.run_round(d[1]) for d in data])
    lf = torch.stack([fleet.run_round(d[1]) for d in data])
    return case, jsess, plain, fleet, data, (lj, lp, lf)


def test_one_rank_fleet_bitwise_single_device(one_rank):
    case, _, plain, fleet, data, (_, lp, lf) = one_rank
    assert isinstance(fleet.engine.mesh, tmesh.FleetMesh)
    assert torch.equal(lp, lf)
    sp_, sf = tree_leaves(plain.state), tree_leaves(fleet.gather_state())
    assert len(sp_) == len(sf)
    assert all(torch.equal(a, b) for a, b in zip(sp_, sf))
    assert plain.meter() == fleet.meter()
    for name in ("bytes_up", "bytes_down", "sync_bytes"):
        assert getattr(plain.engine.meter, name) == getattr(
            fleet.engine.meter, name)
    assert plain.wire_report(data[0][1]) == fleet.wire_report(data[0][1])
    _, ev = _eval_batch(case)
    assert torch.equal(plain.evaluate(ev), fleet.evaluate(ev))
    assert torch.equal(plain.evaluate_all(ev), fleet.evaluate_all(ev))
    if plain.is_split and not plain.engine.topology.parallel_only:
        assert torch.equal(plain.evaluate(ev, client=1),
                           fleet.evaluate(ev, client=1))


def test_one_rank_fleet_against_reference(one_rank):
    case, jsess, _, fleet, data, (lj, _, lf) = one_rank
    np.testing.assert_allclose(lf.numpy(), lj, **TOL)
    want = jax.tree_util.tree_leaves(_np_tree(jsess.state))
    got = jax.tree_util.tree_leaves(
        bridge.tree_to_numpy(fleet.gather_state()))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    assert fleet.meter()["client_gb"] == jsess.meter()["client_gb"]
    assert fleet.wire_report(data[0][1]) == jsess.wire_report(data[0][0])
    ev_j, ev_t = _eval_batch(case)
    assert float(fleet.evaluate(ev_t)) == float(jsess.evaluate(ev_j))
    np.testing.assert_array_equal(fleet.evaluate_all(ev_t).numpy(),
                                  np.asarray(jsess.evaluate_all(ev_j)))
    if case == "physical":       # the p2p handoff crossed, squeezed
        h = fleet.wire_stack.handoff_bytes(
            tree_at(fleet.state["clients"], 0))
        assert fleet.engine.meter.sync_bytes == [h, 2 * h] == \
            jsess.engine.meter.sync_bytes


# ---------------------------------------------------------------------------
# two and four ranks over gloo, against one device
# ---------------------------------------------------------------------------

RANK_CASES = tuple(ranks.CASES) + ("vanilla_pipeline",)
RING_CASES = ("vanilla", "u_shaped", "multihop", "vanilla_pipeline")
TURN_CASES = ("vanilla", "u_shaped", "multihop", "vanilla_dense_none",
              "parallel", "vanilla_pipeline")


@pytest.fixture(scope="module", autouse=True)
def _rank_procs(tmp_path_factory):
    """The 2- and 4-rank spawns, started together with the module's first
    test; whatever is left of them is killed at its end."""
    started = {}
    for world in WORLDS:
        out = str(tmp_path_factory.mktemp(f"fleet{world}"))
        started[world] = (ranks.start(world, out), out)
    yield started
    for procs, _ in started.values():
        ranks.stop(procs)


@pytest.fixture(scope="module")
def rank_results(_rank_procs):
    return {world: ranks.collect(*_rank_procs[world]) for world in WORLDS}


@pytest.fixture(scope="module")
def one_device():
    """Each rank case on one device, in this process."""
    return {name: ranks.run_case(name, None) for name in ranks.CASES}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", RANK_CASES)
def test_ranks_match_one_device(rank_results, one_device, world, case):
    """Losses and the gathered state allclose to one device; meters, wire
    reports and accuracies exactly; every rank gathers the same state and
    holds its share of the clients (the branch kind: all of them)."""
    want = one_device[case.removesuffix("_pipeline")]
    first = rank_results[world][0][case]
    for got in rank_results[world]:
        got = got[case]
        torch.testing.assert_close(got["losses"], want["losses"], **RANK_TOL)
        assert len(got["state"]) == len(want["state"])
        for a, b, c in zip(got["state"], want["state"], first["state"]):
            torch.testing.assert_close(a, b, **RANK_TOL)
            assert torch.equal(a, c)
        assert got["meter"] == want["meter"]
        assert got["wire_report"] == want["wire_report"]
        assert torch.equal(got["evaluate"], want["evaluate"])
        assert torch.equal(got["evaluate_all"], want["evaluate_all"])
        if got["local_clients"] is not None:
            assert got["local_clients"] == (2 if case == "vertical"
                                            else ranks.N_CLIENTS // world)


@pytest.mark.parametrize("world", WORLDS)
def test_round_robin_ranks_are_bitwise(rank_results, one_device, world):
    """The round-robin round's arithmetic does not depend on the rank
    count (no reduction crosses ranks): bitwise one device's."""
    for case in RING_CASES + ("vanilla_dense_none",):
        want = one_device[case.removesuffix("_pipeline")]
        got = rank_results[world][0][case]
        assert torch.equal(got["losses"], want["losses"]), case
        assert all(torch.equal(a, b) for a, b in zip(got["state"],
                                                     want["state"])), case


@pytest.mark.parametrize("world", WORLDS)
def test_ring_hops_carry_the_packed_handoff(rank_results, one_device, world):
    """A round's hops: the wrap-around from the last rank to rank 0, then
    rank d to d+1; each moves exactly `handoff_bytes`, the int8 q and fp32
    row scales (below the dense client's bytes), the price the meter bills
    a handoff."""
    for case in RING_CASES:
        want = one_device[case.removesuffix("_pipeline")]
        for got in rank_results[world]:
            got = got[case]
            h = got["handoff_bytes"]
            assert h == want["handoff_bytes"] < got["client_dense_bytes"]
            assert got["ring_hops"] == [(world - 1, 0, h)] + [
                (d, d + 1, h) for d in range(world - 1)], case
            assert want["meter"][3][1] == ranks.ROUNDS * h
        assert one_device[case.removesuffix("_pipeline")].get(
            "ring_hops") is None
    for got in rank_results[world]:
        assert got["vanilla_dense_none"]["ring_hops"] == []


@pytest.mark.parametrize("world", WORLDS)
def test_wire_calls_summed_over_ranks_match_one_device(rank_results,
                                                       one_device, world):
    """The pack at the source and the unpack on the far rank replace one
    `handoff_recv`: over the ranks the wire kernels run as often as on one
    device (here their plain versions, counted)."""
    for case in TURN_CASES:
        want = one_device[case.removesuffix("_pipeline")]["calls"]
        got = [r[case]["calls"] for r in rank_results[world]]
        for name in want:
            assert sum(c[name] for c in got) == want[name], (case, name)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_checkpoint_round_trip(rank_results, world):
    """Rank 0 writes the gathered state; each rank restores its slice."""
    gathered = rank_results[world][0]["checkpoint"]["gathered"]
    for got in rank_results[world]:
        ck = got["checkpoint"]
        assert all(torch.equal(a, b) for a, b in zip(ck["saved"],
                                                     ck["restored"]))
        assert all(torch.equal(a, b) for a, b in zip(ck["gathered"],
                                                     gathered))


# ---------------------------------------------------------------------------
# validation, the mesh, the refusals, data, collectives, checkpoints, CLI
# ---------------------------------------------------------------------------

def test_fleet_spec_validation():
    with pytest.raises(ValueError, match="client_sharding"):
        FleetSpec(client_sharding="bogus")
    with pytest.raises(NotImplementedError, match="server_replication"):
        FleetSpec(server_replication=False)


class _FakeMesh:
    """A mesh double with a 2-way client axis, so the division check fires
    in one process (before anything reads a rank)."""
    axis_names = ("clients", "model")
    shape = {"clients": 2, "model": 1}


def test_fleet_uneven_clients_rejected():
    _, tm = _models()
    with pytest.raises(ValueError, match="divide evenly"):
        FleetRoundEngine(
            topology=topo.vanilla(tm, 2), loss_fn=softmax_xent,
            optimizer_client=optim.sgd(0.1), optimizer_server=optim.sgd(0.1),
            n_clients=3, fleet=FleetSpec(), mesh=_FakeMesh())


def test_fleet_mesh_and_overcommit_message():
    mesh = tmesh.make_fleet_mesh(device="cpu")
    assert mesh.axis_names == ("clients", "model")
    assert mesh.shape == {"clients": 1, "model": 1}
    assert (mesh.rank, mesh.device) == (0, torch.device("cpu"))
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2.*"
                                         "_torch_fleet_ranks"):
        tmesh.make_fleet_mesh(2, device="cpu")
    with pytest.raises(NotImplementedError, match="model_parallel"):
        tmesh.make_fleet_mesh(1, model_parallel=2, device="cpu")


def test_pipelined_fleet_refused():
    _, tkw = _plan_kwargs("vanilla")
    with pytest.raises(ValueError, match="single-mesh"):
        Plan(fleet=FleetSpec(n_devices=1), schedule="pipelined",
             microbatches=2, **tkw).compile(device="cpu")
    with pytest.raises(NotImplementedError, match="pipelined"):
        FleetRoundEngine(
            topology=topo.vanilla(tkw["model"], 2), loss_fn=softmax_xent,
            optimizer_client=optim.sgd(0.1), optimizer_server=optim.sgd(0.1),
            n_clients=2, schedule="pipelined", fleet=FleetSpec(n_devices=1),
            device="cpu")


def test_monolithic_fleet_refused():
    with pytest.raises(SystemExit, match="monolithic training has no "
                                         "client axis"):
        train.main(["--arch", "mamba2_130m", "--reduced", "--steps", "1",
                    "--mode", "monolithic", "--fleet", "--device", "cpu"])


def test_dirichlet_client_batches_feed_the_fleet():
    """Non-IID stacked batches train the fleet, bitwise the single device."""
    pool = [b for r in range(4) for b in _round_data("vanilla", r)[1]]
    stacked = partition.dirichlet_client_batches(
        torch.Generator().manual_seed(1),
        {k: torch.cat([b[k] for b in pool]) for k in ("x", "labels")},
        N_CLIENTS, 8)
    assert stacked["x"].shape == (N_CLIENTS, 8, HW, HW, 3)
    _, tkw = _plan_kwargs("vanilla")
    out = []
    for fleet in (None, FleetSpec(n_devices=1)):
        sess = Plan(fleet=fleet, **tkw).compile(device="cpu")
        sess.init(seed=0)
        out.append(sess.fit(lambda r: stacked, rounds=2))
    assert all(np.isfinite(out[1])) and out[0] == out[1]


def test_collectives_refuse_tensors_off_the_mesh_device():
    mesh = tmesh.make_fleet_mesh(device="cpu")
    tree = {"a": torch.zeros(2, device="meta")}
    for call in (lambda: tdist.tree_psum(tree, mesh),
                 lambda: tdist.tree_all_gather(tree, mesh),
                 lambda: tdist.tree_replicate_from(tree, mesh, 0),
                 lambda: tdist.tree_ppermute(tree, mesh, [(0, 1)])):
        with pytest.raises(ValueError, match="not staged through the host"):
            call()
    # a hop from a rank to itself moves nothing
    same = {"a": torch.ones(2)}
    assert tdist.tree_ppermute(same, mesh, [(0, 0)]) is same
    tdist.set_mesh(mesh)
    assert tdist.get_mesh() is mesh


def test_one_rank_checkpoint_round_trip(tmp_path):
    _, tkw = _plan_kwargs("physical")
    sess = Plan(fleet=FleetSpec(n_devices=1), **tkw).compile(device="cpu")
    sess.init(seed=0)
    sess.run_round(_round_data("physical", 0)[1])
    save_state(str(tmp_path / "s"), sess, step=1)
    fresh = Plan(fleet=FleetSpec(n_devices=1), **tkw).compile(device="cpu")
    restored = restore_state(str(tmp_path / "s"), fresh)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                                 tree_leaves(sess.state)))


def test_cli_fleet_prints_the_same_json_line(capsys):
    """`--fleet` at one rank prints the run's JSON line as without it (all
    but its wall seconds)."""
    argv = ["--arch", "mamba2_130m", "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "16", "--mode", "split",
            "--n-clients", "2", "--schedule", "parallel", "--log-every",
            "1", "--device", "cpu"]
    lines = []
    for extra in ([], ["--fleet"]):
        train.main(argv + extra)
        out = capsys.readouterr().out.strip().splitlines()
        lines.append((out[:-1], json.loads(out[-1])))
    (log_a, a), (log_b, b) = lines
    assert a.pop("wall_s") is not None and b.pop("wall_s") is not None
    assert a == b and log_a == log_b
