"""The fleet tests' spawn helper: D CPU ranks of the port's fleet over gloo.

`start(world, out_dir)` starts `world` processes of this file, one a
rank, which meet through a file rendezvous in `out_dir`, set one torch
thread, import only `repro_torch`, run every case of `CASES` under
`Plan(fleet=FleetSpec(n_devices=world))` and save what each saw to
`out_dir/rank<r>.pt`; `collect` waits for them and returns the ranks'
results in rank order.  The parent runs the same cases on one device
(`run_case(name, None)`) to hold the ranks to.  As a command:

    python tests/_torch_fleet_ranks.py RANK WORLD OUT_DIR

A case is a Plan over the smoke VGG (configs/vgg_cifar10.py:SMOKE) or two
dense branches, with seeded numpy data: 4 clients (or 2 modalities) of 8
rows, 2 rounds, so the second round's first turn takes its handoff over
the ring's wrap-around.  The round-robin cases and the replicated branch
kind run over the physical int8 wire: their arithmetic does not depend on
the rank count.  The cases whose means reduce over the ranks (parallel,
fedavg, large_batch) run over the dense wire, where the reduction's other
order stays a rounding difference: an int8 wire would carry it on as a
whole quantization level wherever a value lies by a rounding boundary.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
N_CLIENTS, ROUNDS, ROWS, HW, N_CLS, DIM = 4, 2, 8, 32, 4, 64

# name -> Plan keywords (beyond model / optimizer / wire / n_clients)
CASES = {
    "vanilla": dict(mode="vanilla", cut=2, wire="physical"),
    "u_shaped": dict(mode="u_shaped", cuts=(2, 6), wire="physical"),
    "multihop": dict(mode="multihop", cuts=[2, 4], wire="physical"),
    "vanilla_dense_none": dict(mode="vanilla", cut=2, sync="none"),
    "parallel": dict(mode="vanilla", cut=2, schedule="parallel"),
    "fedavg": dict(mode="fedavg", local_steps=2),
    "large_batch": dict(mode="large_batch"),
    "vertical": dict(mode="vertical", wire="physical"),
}


def image_batches(seed: int, n_clients: int = N_CLIENTS,
                  rounds: int = ROUNDS) -> list:
    """`rounds` rounds of [{"x": (ROWS, HW, HW, 3), "labels"}] a client: a
    fixed template per class plus 0.6 noise."""
    rng = np.random.default_rng(seed)
    templates = np.random.default_rng(1234).standard_normal(
        (N_CLS, HW, HW, 3))
    out = []
    for _ in range(rounds):
        labels = rng.integers(0, N_CLS, (n_clients, ROWS))
        x = (templates[labels] + 0.6 * rng.standard_normal(
            (n_clients, ROWS, HW, HW, 3))).astype(np.float32)
        out.append([{"x": torch.from_numpy(x[i]),
                     "labels": torch.from_numpy(labels[i])}
                    for i in range(n_clients)])
    return out


def modal_batches(seed: int, rounds: int = ROUNDS) -> list:
    """{"x": (2, 16, DIM), "labels": (16,)} a round: two modalities, each
    a fixed class vector plus 0.5 noise."""
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(77).standard_normal((2, N_CLS, DIM))
    out = []
    for _ in range(rounds):
        labels = rng.integers(0, N_CLS, (16,))
        x = (w[:, labels] + 0.5 * rng.standard_normal((2, 16, DIM))
             ).astype(np.float32)
        out.append({"x": torch.from_numpy(x),
                    "labels": torch.from_numpy(labels)})
    return out


def make_plan(name: str, fleet):
    from repro_torch import optim
    from repro_torch.api import Plan, quantize_int8
    from repro_torch.configs import vgg_cifar10
    from repro_torch.core import split as sp
    from repro_torch.nn import convnets as C
    from repro_torch.nn import layers as L

    kw = dict(CASES[name])
    wire = [quantize_int8(physical=True)] if kw.pop("wire", None) else []
    if kw["mode"] == "vertical":
        branch = sp.Branch(
            init=lambda g: {"w": L.dense_init(g, DIM, 16, bias=True)},
            apply=lambda p, x: torch.relu(L.dense_apply(p["w"], x)))
        trunk = (lambda g: {"w": L.dense_init(g, 32, N_CLS, bias=True)},
                 lambda p, f: L.dense_apply(p["w"], f))
        return Plan(branch=branch, trunk=trunk, n_clients=2, wire=wire,
                    optimizer=optim.adamw(1e-2), fleet=fleet, **kw)
    cfg = vgg_cifar10.SMOKE
    plan = C.vgg_plan(cfg)
    model = sp.list_segmodel(
        len(plan), lambda g: C.vgg_init(g, cfg),
        lambda p, i, x: C.vgg_layer_apply(p, plan[i], x))
    return Plan(model=model, n_clients=N_CLIENTS, wire=wire,
                optimizer=optim.adamw(1e-2), fleet=fleet, **kw)


def case_batches(name: str) -> list:
    if CASES[name]["mode"] == "vertical":
        return modal_batches(7)
    return image_batches(5)


@contextlib.contextmanager
def count_wire_calls():
    """Counts the wire kernels' plain versions called on CPU tensors (the
    meta probes excluded): where a card launches a kernel, the CPU calls
    its plain version, so these count the launches a card would make."""
    from repro_torch.kernels import ref

    counts = {"wire_quant": 0, "wire_dequant": 0}
    saved = ref.wire_quant_ref, ref.wire_dequant_ref

    def wrap(name, fn):
        def counted(x, *a, **k):
            if x.device.type == "cpu":
                counts[name] += 1
            return fn(x, *a, **k)
        return counted
    ref.wire_quant_ref = wrap("wire_quant", saved[0])
    ref.wire_dequant_ref = wrap("wire_dequant", saved[1])
    try:
        yield counts
    finally:
        ref.wire_quant_ref, ref.wire_dequant_ref = saved


def run_case(name: str, fleet, *, pipeline: bool = False) -> dict:
    """One case trained for ROUNDS rounds on the CPU: what the tests
    compare.  `pipeline` feeds each round through `DataPipeline` with
    `sharded_put`, so a rank receives only its own clients' rows."""
    from repro_torch.core.accounting import bytes_of_tree
    from repro_torch.data.pipeline import DataPipeline, sharded_put
    from repro_torch.engine import stack_batches, tree_at
    from repro_torch.nn.module import tree_leaves

    sess = make_plan(name, fleet).compile(device="cpu")
    sess.init(seed=0)
    batches = case_batches(name)
    if pipeline:
        feed = DataPipeline(iter(stack_batches(b) for b in batches),
                            sharded_put(sess.engine.mesh,
                                        {"x": "clients",
                                         "labels": "clients"}))
    else:
        feed = iter(batches)
    with count_wire_calls() as calls:
        losses = [sess.run_round(next(feed)) for _ in range(ROUNDS)]
    ev = (modal_batches(11, 1)[0] if CASES[name]["mode"] == "vertical"
          else image_batches(11, 1, 1)[0][0])
    state = sess.gather_state()
    meter = sess.engine.meter
    out = {"losses": torch.stack(losses),
           "state": tree_leaves(state),
           "meter": (sess.meter(), meter.bytes_up, meter.bytes_down,
                     meter.sync_bytes),
           "wire_report": sess.wire_report(batches[0]),
           "evaluate": sess.evaluate(ev, client=N_CLIENTS - 1)
           if sess.is_split and not sess.engine.topology.parallel_only
           else sess.evaluate(ev),
           "evaluate_all": sess.evaluate_all(ev),
           "calls": dict(calls),
           "local_clients": (tree_leaves(sess.state["clients"])[0].shape[0]
                             if sess.is_split else None)}
    if sess.is_split and sess.wire_stack.has_handoff:
        client = tree_at(state["clients"], 0)
        out["handoff_bytes"] = sess.wire_stack.handoff_bytes(client)
        out["client_dense_bytes"] = bytes_of_tree(client)
    engine = sess.engine
    if hasattr(engine, "mesh"):
        out["ring_hops"] = list(getattr(engine, "ring_hops", []))
        out["counts"] = dict(engine.mesh.counts)
        engine.mesh.counts.clear()
    return out


def rank_main(rank: int, world: int, out_dir: str):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
        rank=rank, world_size=world)
    from repro_torch.api import FleetSpec

    fleet = FleetSpec(n_devices=world)
    results = {name: run_case(name, fleet) for name in CASES}
    results["vanilla_pipeline"] = run_case("vanilla", fleet, pipeline=True)
    results["checkpoint"] = checkpoint_round_trip(fleet, out_dir)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def checkpoint_round_trip(fleet, out_dir: str) -> dict:
    """One round of the vanilla case, `save_state` (rank 0 writes the
    gathered state), then `restore_state` into a fresh session: the rank's
    slice and the gathered state, before and after."""
    import torch.distributed as dist

    from repro_torch.checkpoint import restore_state, save_state
    from repro_torch.nn.module import tree_leaves

    sess = make_plan("vanilla", fleet).compile(device="cpu")
    sess.init(seed=0)
    sess.run_round(case_batches("vanilla")[0])
    path = os.path.join(out_dir, "ckpt", "state")
    save_state(path, sess, step=1)
    dist.barrier()
    fresh = make_plan("vanilla", fleet).compile(device="cpu")
    fresh.init(seed=1)
    restore_state(path, fresh)
    return {"saved": tree_leaves(sess.state),
            "restored": tree_leaves(fresh.state),
            "gathered": tree_leaves(fresh.gather_state())}


def start(world: int, out_dir: str, cmd: list | None = None) -> list:
    """Start `world` ranks of this file, or of the script and leading
    arguments `cmd`, each given RANK WORLD OUT_DIR after them (see
    `collect`)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [SRC] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [os.path.abspath(__file__)] if cmd is None else cmd
    procs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, *cmd, str(r), str(world), out_dir],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def stop(procs: list):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def collect(procs: list, out_dir: str, timeout: float = 180.0) -> list:
    """Wait for the ranks `start` began (killing any left after
    `timeout`); their results in rank order."""
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        stop(procs)
    bad = []
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out_dir, f"rank{r}.log")) as log:
                bad.append((r, p.returncode, log.read()[-4000:]))
    if bad:
        raise RuntimeError(f"fleet ranks failed: {bad}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
