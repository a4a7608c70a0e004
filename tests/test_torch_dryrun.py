"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX
reference's shapes and specs, on the CPU.

* Per-device argument bytes for every (arch, shape) that
  `supports_shape` admits, at both production meshes (the reference
  tests' `FakeMesh`): the port's params, AdamW state and caches hold
  exactly the bytes that the reference's `jax.eval_shape` trees hold
  under the reference's specs, summed leaf by leaf over one device's
  shards; the batch the same number of elements (the port's token ids
  are int64, the reference's int32).  A ring's `pos` is left out: the
  port keeps it as a host int, the reference as an int32 per layer.
* `lower_combo` at reduced depth (2 layers, full width; see
  `tests/_torch_fake_mesh.py`) over a fake 256-rank process group and
  the real `make_production_mesh()`, in a subprocess: every combo of one
  arch of each family ends "ok" (Whisper's long_500k "skipped").
* In the same subprocess, `param_shardings` of full-size phi4-mini and
  Qwen3-30B-A3B: every leaf's `distribute_tensor(...).to_local()` shape
  equals the spec-derived local shape.
* The prefill `step_flops` of a reduced phi4-mini equals the hand count
  of its matmuls exactly.
* `python -m repro_torch.launch.dryrun --mesh both` (one process a
  mesh) writes one entry per (arch, shape, mesh).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import optim as joptim
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import mesh as jmesh
from repro.models import build_model as jbuild_model
from repro.models import input_specs as jinput_specs
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.models import supports_shape
from _torch_threads import one_torch_thread

one_torch_thread()

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


@dataclasses.dataclass
class FakeMesh:
    shape: dict
    axis_names: tuple


SINGLE = FakeMesh({"data": 16, "model": 16}, ("data", "model"))
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16},
                 ("pod", "data", "model"))


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _local(shape, spec, mesh) -> int:
    n = 1
    for d, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        size = 1
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else ax):
            size *= mesh.shape[a]
        assert d % size == 0
        n *= d // size
    return n


def ref_sum(shapes, specs, mesh, *, elements=False, skip_pos=False) -> int:
    """One device's bytes (elements) of a reference tree under specs."""
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=_is_spec)
    assert len(leaves) == len(spec_leaves)
    total = 0
    for (path, leaf), spec in zip(leaves, spec_leaves):
        if skip_pos and jmesh.nn._path_elem_str(path[-1]) == "pos":
            continue
        n = _local(leaf.shape, spec, mesh)
        total += n if elements else n * leaf.dtype.itemsize
    return total


@functools.lru_cache(maxsize=None)
def _ref_model(arch, long_context):
    model = jbuild_model(jget_config(arch), long_context=long_context)
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


def ref_bytes(arch, shape_name, mesh) -> dict:
    shape = JSHAPES[shape_name]
    model, pshapes = _ref_model(arch, shape_name == "long_500k")
    specs_in = jinput_specs(model.cfg, shape)
    p_specs = jmesh.param_pspecs(pshapes, mesh)
    out = {"params": ref_sum(pshapes, p_specs, mesh)}
    if shape.kind == "train":
        opt = jax.eval_shape(joptim.adamw(3e-4).init, pshapes)
        out["opt_state"] = ref_sum(opt, jmesh.opt_pspecs(opt, p_specs),
                                   mesh)
    if shape.kind == "decode":
        if model.cfg.encdec:
            caches = jax.eval_shape(
                functools.partial(model.init_cache, max_len=shape.seq_len),
                pshapes, specs_in["audio_feats"])
        else:
            caches = jax.eval_shape(
                lambda: model.init_cache(shape.global_batch, shape.seq_len))
        out["caches"] = ref_sum(caches, jmesh.cache_pspecs(caches, mesh),
                                mesh, skip_pos=True)
        specs_in = {"tokens": specs_in["tokens"]}
    out["batch_elements"] = ref_sum(specs_in, jmesh.batch_pspecs(specs_in,
                                                                 mesh),
                                    mesh, elements=True)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_device_argument_bytes_match_reference(arch):
    cfg = get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        if not supports_shape(cfg, shape)[0]:
            continue
        for mesh in (SINGLE, MULTI):
            want = ref_bytes(arch, name, mesh)
            _, args, got = dryrun.combo_args(cfg, name, mesh)
            batch = {"train": lambda: args[2], "prefill": lambda: args[1],
                     "decode": lambda: {"tokens": args[1]}}[shape.kind]()
            elements = sum(
                int(np.prod(meshlib.local_shape(tuple(t.shape), s, mesh)))
                for t, s in zip(
                    [batch[k] for k in sorted(batch)],
                    [meshlib.batch_pspecs(batch, mesh)[k]
                     for k in sorted(batch)]))
            assert elements == want.pop("batch_elements"), (name, mesh)
            got = {k: v for k, v in got.items() if k != "batch"}
            assert got == want, (name, mesh.shape)


@pytest.fixture(scope="module")
def fake_mesh_run():
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_fake_mesh.py")],
        capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


FAMILIES = ["phi4_mini_3_8b", "qwen3_moe_30b_a3b", "deepseek_v2_236b",
            "mamba2_130m", "recurrentgemma_2b", "internvl2_2b",
            "whisper_base"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_lower_combo_reduced_on_fake_256_ranks(fake_mesh_run, arch):
    for name in INPUT_SHAPES:
        r = fake_mesh_run["combos"][f"{arch}|{name}"]
        if arch == "whisper_base" and name == "long_500k":
            assert r["status"] == "skipped"
            continue
        assert r["status"] == "ok", r.get("error")
        assert r["mesh"] == "16x16" and r["n_devices"] == 256
        assert r["step_flops"] > 0
        b = r["per_device_bytes"]
        assert b["arguments"] == sum(v for k, v in b.items()
                                     if k != "arguments")


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "qwen3_moe_30b_a3b"])
def test_param_shardings_local_shapes(fake_mesh_run, arch):
    r = fake_mesh_run["shardings"][arch]
    assert r["bad"] == []
    assert r["sharded"] > r["leaves"] // 2       # most leaves are split


def test_prefill_step_flops_hand_count():
    cfg = get_config("phi4_mini_3_8b").reduced()
    r = dryrun.lower_combo("phi4_mini_3_8b", "prefill_32k", SINGLE,
                           cfg=cfg)
    shape = INPUT_SHAPES["prefill_32k"]
    B, S = shape.global_batch, shape.seq_len
    T = B * S
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
        cfg.resolved_head_dim
    F, V = cfg.d_ff, cfg.vocab
    per_layer = (2 * T * D * H * hd            # wq
                 + 2 * 2 * T * D * K * hd      # wk, wv
                 + 2 * T * H * hd * D          # wo
                 + 2 * 2 * B * H * S * S * hd  # q k^T and p v, all pairs
                 + 3 * 2 * T * D * F)          # gate, up, down
    want = cfg.n_layers * per_layer + 2 * T * D * V   # the tied head
    assert r["step_flops"] == want


def test_main_writes_every_mesh(tmp_path):
    results = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper_base", "--shape", "decode_32k,long_500k", "--mesh",
         "both", "--results", str(results)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    db = json.loads(results.read_text())
    assert set(db) == {f"whisper_base|{s}|{m}" for s in
                       ("decode_32k", "long_500k")
                       for m in ("single", "multi")}
    assert db["whisper_base|decode_32k|multi"]["mesh"] == "2x16x16"
    assert db["whisper_base|long_500k|single"]["status"] == "skipped"
    assert "DRY-RUN SUMMARY: ok=2 skipped=2 errors=0" in out.stdout
