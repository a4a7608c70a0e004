"""The port's training CLI (`repro_torch.launch.train`) and checkpoints
against the reference's (`repro.launch.train`, `repro.checkpoint`), on the
CPU, at reduced size in fp32.

* `build_plan`: for each mode, schedule and client count, the port's
  `Plan` has the reference's mode, cut, clients, schedule, microbatches,
  local steps, clip norm and wire transform names.
* One reduced CLI run of each package (`--mode split --n-clients 2
  --wire quantize_int8:physical`, 2 steps): the same JSON keys in the same
  order, and `wire_report` and `client_gb` BITWISE (the losses differ:
  each package draws its own batches and weights from its own generator).
* The refusals: `--fleet`, a non-vanilla `--topology` and an unported
  `--arch` exit with a message naming ROADMAP.md.
* Every mode under every schedule the reference accepts runs, and prints
  the reference's keys.
* Checkpoints: a checkpoint the port writes restores through the
  reference's `ckpt.restore`, and the reverse, leaf for leaf BITWISE, with
  the same paths, shapes, dtypes and step in the manifest; a bf16 leaf is
  stored as the reference stores it (its raw 16-bit pattern).
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.engine import tree_index as jtree_index
from repro.launch import train as jtrain
from repro.models import build_model as jbuild_model
from repro_torch import bridge
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.engine import tree_at
from repro_torch.launch import train
from repro_torch.models import build_model
from repro_torch.nn.module import tree_leaves

ARCH = "phi4_mini_3_8b"
FAST = ["--batch", "2", "--seq", "8", "--log-every", "0"]


def _args(argv):
    args = train.parser().parse_args(["--arch", ARCH, "--reduced"] + argv)
    args.cut = 1
    return args


def _models(arch=ARCH):
    return (jbuild_model(jget_config(arch).reduced(vocab=256)),
            build_model(get_config(arch).reduced(vocab=256)))


def _last_json(out: str) -> tuple:
    lines = out.strip().splitlines()
    return lines[-2], json.loads(lines[-1])


def test_build_plan_matches_reference():
    jm, tm = _models()
    cases = [(mode, sched, n)
             for mode in ("monolithic", "split", "fedavg", "large_batch")
             for sched in ("round_robin", "parallel", "pipelined")
             for n in (1, 3)]
    for mode, sched, n in cases:
        argv = ["--mode", mode, "--schedule", sched, "--n-clients", str(n),
                "--microbatches", "2" if sched == "pipelined" else "1",
                "--local-steps", "2", "--wire",
                "quantize_int8:physical,dp_noise:0.05,leakage_probe"]
        pj, pt = jtrain.build_plan(jm, _args(argv)), train.build_plan(
            tm, _args(argv))
        for f in ("mode", "cut", "n_clients", "schedule", "microbatches",
                  "local_steps", "clip_norm"):
            assert getattr(pt, f) == getattr(pj, f), (mode, sched, n, f)
        assert [w.name for w in pt.wire] == [w.name for w in pj.wire]
    split = train.build_plan(tm, _args(["--mode", "split"]))
    assert split.mode == "vanilla" and split.clip_norm == 1.0
    assert [w.name for w in split.wire] == []


def test_cli_run_matches_reference(monkeypatch, capsys):
    argv = ["--arch", ARCH, "--reduced", "--steps", "2", "--mode", "split",
            "--n-clients", "2", "--wire", "quantize_int8:physical",
            "--log-every", "0"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain.main()
    eval_j, sj = _last_json(capsys.readouterr().out)
    run = train.main(argv + ["--device", "cpu"])
    eval_t, st = _last_json(capsys.readouterr().out)
    assert eval_j.startswith("eval acc/client: [")
    assert eval_t.startswith("eval acc/client: [")
    assert list(st) == list(sj)
    assert st["wire_report"] == sj["wire_report"]
    assert st["client_gb"] == sj["client_gb"]
    assert st["client_gb"][0] < st["client_gb"][1]
    for k in ("arch", "mode", "steps", "n_clients", "schedule",
              "microbatches", "topology", "wire"):
        assert st[k] == sj[k], k
    assert json.loads(json.dumps(run.summary)) == st
    assert len(run.losses) == 2
    # the JSON line is what the session meters
    assert st["client_gb"] == [round(g, 6) for g in
                               run.session.meter()["client_gb"]]


def test_cli_refusals():
    for argv in (["--mode", "split", "--fleet"],
                 ["--mode", "monolithic", "--fleet"],
                 ["--mode", "split", "--topology", "u_shaped"],
                 ["--arch", "internvl2_2b"]):
        full = ["--arch", ARCH, "--reduced", "--steps", "1", "--device",
                "cpu"] + argv
        with pytest.raises(SystemExit, match="ROADMAP.md"):
            train.main(full)
    with pytest.raises(SystemExit, match="quantize_int8:slow"):
        train.main(["--arch", ARCH, "--reduced", "--mode", "split",
                    "--wire", "quantize_int8:slow", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--arch", ARCH, "--reduced", "--steps", "1"])


def test_cli_every_mode_and_schedule_runs(capsys):
    runs = [(ARCH, mode, sched)
            for mode in ("monolithic", "split", "fedavg", "large_batch")
            for sched in ("round_robin", "parallel", "pipelined")]
    runs += [("mamba2_130m", "split", "round_robin"),
             ("recurrentgemma_2b", "split", "pipelined"),
             ("recurrentgemma_2b", "fedavg", "round_robin")]
    keys = ["arch", "mode", "steps", "wall_s", "first_loss", "final_loss",
            "eval_acc_per_client"]
    split_keys = ["n_clients", "schedule", "microbatches", "topology",
                  "client_gb", "wire", "wire_report"]
    for arch, mode, sched in runs:
        argv = ["--arch", arch, "--reduced", "--steps", "1", "--mode", mode,
                "--schedule", sched, "--n-clients", "2", "--local-steps", "2",
                "--microbatches", "2" if sched == "pipelined" else "1",
                "--wire", "quantize_int8:physical,dp_noise:0.05",
                "--device", "cpu"] + FAST
        run = train.main(argv)
        eval_line, summary = _last_json(capsys.readouterr().out)
        assert eval_line.startswith("eval acc/client:")
        assert list(summary) == keys + (split_keys if mode == "split"
                                        else [])
        assert all(np.isfinite(run.losses)), (arch, mode, sched)
        n_eval = 2 if mode == "split" else 1
        assert len(summary["eval_acc_per_client"]) == n_eval


def _port_split_run(tmp_path, n_clients, extra=()):
    prefix = str(tmp_path / f"split{n_clients}")
    run = train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--mode",
                      "split", "--n-clients", str(n_clients), "--ckpt",
                      prefix, "--device", "cpu", *extra] + FAST)
    return prefix, run


def _ref_session(argv):
    jm, _ = _models()
    sess = jtrain.build_plan(jm, _args(argv)).compile()
    sess.init(jax.random.PRNGKey(0))
    return sess


def _assert_bitwise(np_tree, j_tree):
    a = jax.tree_util.tree_leaves(np_tree)
    b = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, j_tree))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_port_checkpoints_restore_through_the_reference(tmp_path):
    """The CLI's files (`.clients` stacked, `.client`, `.server` and a
    monolithic run's global model) restore through `repro.checkpoint` into
    the reference's own templates, bitwise the port's state."""
    for n in (2, 1):
        prefix, run = _port_split_run(tmp_path, n)
        jsess = _ref_session(["--mode", "split", "--n-clients", str(n)])
        state = run.session.state
        if n > 1:
            pairs = [(".clients", jsess.state["clients"],
                      bridge.lm_tree_to_ref(state["clients"], axis=1))]
        else:
            pairs = [(".client", jtree_index(jsess.state["clients"], 0),
                      bridge.lm_tree_to_ref(tree_at(state["clients"], 0)))]
        pairs.append((".server", jsess.state["server"],
                      bridge.lm_tree_to_ref(state["server"])))
        for suffix, template, port_tree in pairs:
            got = jckpt.restore(prefix + suffix, template)
            _assert_bitwise(bridge.tree_to_numpy(port_tree), got)
            man = ckpt.load_manifest(prefix + suffix)
            jckpt.save(str(tmp_path / "ref"), template, step=2)
            assert man == jckpt.load_manifest(str(tmp_path / "ref"))
    prefix = str(tmp_path / "mono")
    run = train.main(["--arch", ARCH, "--reduced", "--steps", "1",
                      "--ckpt", prefix, "--device", "cpu"] + FAST)
    jsess = _ref_session(["--mode", "monolithic"])
    got = jckpt.restore(prefix, jsess.state["global"])
    _assert_bitwise(bridge.tree_to_numpy(
        bridge.lm_tree_to_ref(run.session.state["global"])), got)
    assert ckpt.load_manifest(prefix)["step"] == 1


def test_reference_checkpoints_restore_into_the_port(tmp_path):
    """A reference server and stacked clients restore through the port's
    `checkpoint.restore` (templates from the port's session), bitwise, and
    train on from there."""
    _, run = _port_split_run(tmp_path, 2)
    sess = run.session
    jsess = _ref_session(["--mode", "split", "--n-clients", "2"])
    for key, axis in (("server", 0), ("clients", 1)):
        path = str(tmp_path / f"ref_{key}")
        jckpt.save(path, jsess.state[key], step=7, extra={"k": key})
        tmpl = bridge.lm_tree_to_ref(sess.state[key], axis=axis)
        got = ckpt.restore(path, tmpl)
        _assert_bitwise(bridge.tree_to_numpy(got), jsess.state[key])
        assert all(t.device == u.device and t.dtype == u.dtype
                   for t, u in zip(tree_leaves(got), tree_leaves(tmpl)))
        sess.state[key] = bridge.lm_tree_from_ref(got, axis=axis)
        assert ckpt.load_manifest(path)["extra"] == {"k": key}
    losses = sess.run_round(run.round_batches(5))
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    # a shape the template does not have
    bad = bridge.lm_tree_to_ref(sess.state["server"])
    bad["final_norm"]["scale"] = torch.zeros(3)
    with pytest.raises(ValueError, match="final_norm/scale"):
        ckpt.restore(str(tmp_path / "ref_server"), bad)


def test_checkpoint_bf16_leaves_as_the_reference_stores_them(tmp_path):
    """A bf16 leaf: the reference's npz holds its raw 16-bit pattern
    (numpy's `<V2`) with "bfloat16" in the manifest; the port writes the
    same bytes and manifest and reads the reference's back bitwise.  (The
    reference's own restore cannot cast `<V2` back.)"""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    jtree = {"w": jnp.asarray(x, jnp.bfloat16), "n": [jnp.arange(3)],
             "s": jnp.asarray(x[0])}
    ttree = {"w": torch.from_numpy(x).to(torch.bfloat16),
             "n": [torch.arange(3, dtype=torch.int32)],
             "s": torch.from_numpy(x[0])}
    jckpt.save(str(tmp_path / "ref"), jtree, step=3)
    ckpt.save(str(tmp_path / "port"), ttree, step=3)
    assert (ckpt.load_manifest(str(tmp_path / "port"))
            == jckpt.load_manifest(str(tmp_path / "ref")))
    with np.load(tmp_path / "ref.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()
    got = ckpt.restore(str(tmp_path / "ref"), ttree)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["w"].view(torch.int16).numpy(),
        np.asarray(jtree["w"]).view(np.int16))
    assert torch.equal(got["n"][0], ttree["n"][0])
    assert torch.equal(got["s"], ttree["s"])
