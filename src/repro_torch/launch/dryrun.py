"""The multi-pod dry run: every (arch x input shape x production mesh)
traced at full size on meta tensors (port of `repro/launch/dryrun.py`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch phi4_mini_3_8b --shape long_500k --mesh single --force

For each combo `lower_combo` builds the model on `device="meta"` (the
long-context variant at `long_500k`), with its optimizer state (train),
its inputs (`models.input_specs`) and its decode caches, lays every
leaf on the production mesh by the sharding rules of `launch.mesh`, and
records:

* `per_device_bytes`: exactly the bytes one device holds of the step's
  arguments under those specs (params + AdamW state + batch for a train
  step, params + batch for prefill, params + tokens + caches for
  decode), in all (`arguments`) and by part;
* `step_flops`: the whole step's floating-point operations, counted by
  `torch.utils.flop_counter.FlopCounterMode` over one trace of the step
  at global shapes on meta (the train step: the loss with `remat=True`,
  its gradient, `clip_by_global_norm(grads, 1.0)` and AdamW(3e-4)).
  XLA's per-device `cost_analysis` has no counterpart here;
* `status`: "ok", "skipped" (`models.supports_shape`'s reason) or
  "error" (the exception, which names the op that failed).

Eager PyTorch has no SPMD partitioner, so nothing is compiled or run
sharded: the reference's output / temp / alias bytes, which come from
XLA's memory analysis of the partitioned program, have no counterpart,
and neither has `collective_bytes_of_hlo`, which reads the collectives
out of the partitioned HLO text. Collective bytes wait for a measured
multi-chip cell (ROADMAP.md).

The production mesh is a `DeviceMesh` over the default process group,
so `main` first makes a fake process group (backend "fake", torch's
`FakeStore`) of the mesh's 256 or 512 ranks in this one process: the
counterpart of the reference's `XLA_FLAGS` placeholder devices.  A
process holds one default group, so `--mesh both` runs each mesh in a
process of its own.  Results go to the checkout's
`build/dryrun_torch.json` (or `--results`); a cached ok / skipped entry is kept unless `--force`.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import optim
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.core.split import _grads, _leaf_params
from repro_torch.launch import mesh as meshlib
from repro_torch.models import build_model, input_specs, supports_shape

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun_torch.json")
MESHES = {"single": False, "multi": True}


def build_train_step(model, opt):
    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            p = _leaf_params(params)
            loss = model.loss(p, batch, remat=True)
            grads = _grads(loss, p)
        grads, _ = optim.clip_by_global_norm(grads, 1.0)
        ups, opt_state = opt.update(grads, opt_state, params)
        params = optim.apply_updates(params, ups)
        return params, opt_state, loss.detach()
    return train_step


def build_prefill_step(model):
    def prefill_step(params, batch):
        return model.forward(params, batch)[:, -1:, :]   # next-token logits
    return prefill_step


def build_serve_step(model):
    def serve_step(params, tokens, caches):
        return model.decode_step(params, tokens, caches)
    return serve_step


def combo_args(cfg, shape, mesh, *, fsdp: bool = False):
    """(step, args, bytes) of one admitted (config, shape) on `mesh`: the
    step function, its arguments on meta tensors at global shapes, and
    the bytes one device holds of each part of them under the sharding
    rules ("params", "opt_state", "caches", "batch").  `shape` is an
    `InputShape` or the name of one of `INPUT_SHAPES`."""
    if isinstance(shape, str):
        shape = INPUT_SHAPES[shape]
    model = build_model(cfg, long_context=shape.name == "long_500k")
    batch = input_specs(cfg, shape)
    params = model.init(torch.Generator(), "meta")
    p_specs = meshlib.param_pspecs(params, mesh, fsdp=fsdp)
    nbytes = {"params": meshlib.local_bytes(params, p_specs, mesh)}
    if shape.kind == "train":
        opt = optim.adamw(3e-4)
        opt_state = opt.init(params)
        nbytes["opt_state"] = meshlib.local_bytes(
            opt_state, meshlib.opt_pspecs(opt_state, p_specs), mesh)
        step, args = build_train_step(model, opt), (params, opt_state, batch)
    elif shape.kind == "prefill":
        step, args = build_prefill_step(model), (params, batch)
    else:
        if cfg.encdec:
            with torch.no_grad():
                caches = model.init_cache(params, batch["audio_feats"],
                                          max_len=shape.seq_len)
        else:
            caches = model.init_cache(shape.global_batch, shape.seq_len,
                                      device="meta")
        nbytes["caches"] = meshlib.local_bytes(
            caches, meshlib.cache_pspecs(caches, mesh), mesh)
        batch = {"tokens": batch["tokens"]}
        step, args = build_serve_step(model), (params, batch["tokens"],
                                               caches)
    nbytes["batch"] = meshlib.local_bytes(
        batch, meshlib.batch_pspecs(batch, mesh), mesh)
    return step, args, nbytes


def lower_combo(arch_id: str, shape_name: str, mesh, *, cfg=None,
                fsdp: bool = os.environ.get("REPRO_FSDP", "0") == "1"):
    """Trace one (arch, shape, mesh) on meta tensors.  `cfg` replaces the
    arch's config (a reduced depth, say).  Returns the result dict."""
    cfg = get_config(arch_id) if cfg is None else cfg
    ok, why = supports_shape(cfg, INPUT_SHAPES[shape_name])
    if not ok:
        return {"status": "skipped", "reason": why}
    step, args, nbytes = combo_args(cfg, shape_name, mesh, fsdp=fsdp)
    t0 = time.time()
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        step(*args)
    t_trace = time.time() - t0

    axes = meshlib.mesh_axes(mesh)
    return {
        "status": "ok",
        "mesh": "x".join(str(s) for s in axes.values()),
        "n_devices": math.prod(axes.values()),
        "trace_s": round(t_trace, 1),
        "per_device_bytes": {"arguments": sum(nbytes.values()), **nbytes},
        "step_flops": float(fc.get_total_flops()),
    }


def init_fake_group(world_size: int) -> None:
    """A fake process group of `world_size` ranks in this process (rank
    0): collectives do nothing, and `make_production_mesh` builds its
    `DeviceMesh` over it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _load(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def run_mesh(mtag: str, archs: list, shapes: list, results: str,
             force: bool) -> None:
    """Every (arch, shape) on one production mesh, in this process (whose
    default process group becomes the mesh's fake group)."""
    multi = MESHES[mtag]
    init_fake_group(math.prod(meshlib.production_shape(multi)[0]))
    mesh = meshlib.make_production_mesh(multi_pod=multi)
    db = _load(results)
    for a in archs:
        for s in shapes:
            key = f"{a}|{s}|{mtag}"
            if key in db and db[key].get("status") in ("ok", "skipped") \
                    and not force:
                print(f"[cached] {key}: {db[key]['status']}")
                continue
            print(f"[run] {key} ...", flush=True)
            try:
                db[key] = lower_combo(a, s, mesh)
            except Exception as e:
                db[key] = {"status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
            print(f"  -> {db[key]['status']} "
                  f"({db[key].get('trace_s', '?')}s trace)", flush=True)
            with open(results, "w") as f:
                json.dump(db, f, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(os.path.abspath(args.results)),
                exist_ok=True)
    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.shape == "all" \
        else args.shape.split(",")
    t0 = time.time()
    if args.mesh == "both":
        # one process a mesh: a process holds one default process group
        for mtag in MESHES:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", args.arch, "--shape", args.shape, "--mesh",
                   mtag, "--results", args.results]
            if args.force:
                cmd.append("--force")
            subprocess.run(cmd, check=True)
    else:
        run_mesh(args.mesh, archs, shapes, args.results, args.force)

    db = _load(args.results)
    n = {st: sum(1 for v in db.values() if v["status"] == st)
         for st in ("ok", "skipped", "error")}
    print(f"\nDRY-RUN SUMMARY: ok={n['ok']} skipped={n['skipped']} "
          f"errors={n['error']} ({time.time() - t0:.1f} s)")
    for k, v in db.items():
        if v["status"] == "error":
            print(f"  ERROR {k}: {v['error']}")


if __name__ == "__main__":
    main()
