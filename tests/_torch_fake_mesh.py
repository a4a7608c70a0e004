"""Run the dry run's parts over a fake 256-rank process group, in a
process of its own (a process holds one default group), and print one
JSON line of results.  `tests/test_torch_dryrun.py` starts it:

    PYTHONPATH=src python tests/_torch_fake_mesh.py

* `lower_combo` at reduced depth (2 layers, full width; RecurrentGemma
  4: a (rglru, rglru, attn) super-block and its remainder layer; Whisper
  2 + 2) for one arch of each family, at every input shape it admits,
  on `make_production_mesh()` (16, 16): each combo's status, error and
  bytes;
* `param_shardings` of full-size phi4-mini and Qwen3-30B-A3B (on meta):
  for every leaf, `distribute_tensor(leaf, *sharding).to_local().shape`
  against `local_shape(leaf.shape, spec)`, the mismatches listed.
"""
import dataclasses
import json
import time

import torch
from torch.distributed.tensor import distribute_tensor

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.models import build_model
from repro_torch.nn.module import tree_leaves, tree_paths

# one arch of each family (DeepSeek-V2 for MLA beside Qwen3's GQA MoE)
REDUCED = {
    "phi4_mini_3_8b": dict(n_layers=2),
    "qwen3_moe_30b_a3b": dict(n_layers=2),
    "deepseek_v2_236b": dict(n_layers=2),
    "mamba2_130m": dict(n_layers=2),
    "recurrentgemma_2b": dict(n_layers=4),
    "internvl2_2b": dict(n_layers=2),
    "whisper_base": dict(n_layers=2, n_enc_layers=2),
}
SHARDED = ("phi4_mini_3_8b", "qwen3_moe_30b_a3b")


def main():
    dryrun.init_fake_group(256)
    mesh = meshlib.make_production_mesh()
    combos = {}
    for arch, red in REDUCED.items():
        cfg = dataclasses.replace(get_config(arch), **red)
        for shape in INPUT_SHAPES:
            try:
                r = dryrun.lower_combo(arch, shape, mesh, cfg=cfg)
            except Exception as e:          # recorded, as main() does
                r = {"status": "error", "error": f"{type(e).__name__}: {e}"}
            combos[f"{arch}|{shape}"] = r
    shardings = {}
    for arch in SHARDED:
        t0 = time.time()
        params = build_model(get_config(arch)).init(torch.Generator(),
                                                    "meta")
        specs = meshlib.spec_leaves(meshlib.param_pspecs(params, mesh))
        shards = meshlib.spec_leaves(meshlib.param_shardings(params, mesh))
        bad = []
        for path, leaf, spec, sh in zip(tree_paths(params),
                                        tree_leaves(params), specs, shards,
                                        strict=True):
            got = tuple(distribute_tensor(leaf, *sh).to_local().shape)
            want = meshlib.local_shape(tuple(leaf.shape), spec, mesh)
            if got != want:
                bad.append(["/".join(path), got, want])
        shardings[arch] = {"leaves": len(specs), "bad": bad,
                           "sharded": sum(any(s) for s in specs),
                           "seconds": time.time() - t0}
    print(json.dumps({"combos": combos, "shardings": shardings}))


if __name__ == "__main__":
    main()
