"""Split-serving entry point (port of `repro/launch/serve.py`, split
mode).

Serves a model split at the cut through `serve.ServeSession`: prefill,
then greedy decode, with `--wire quantize_int8:physical` shipping the
packed int8 payload up and the quantized logits down.  Runs on the GPU
unless `--device cpu`.  Every phase runs once for warmup; timings are
fenced by `torch.cuda.synchronize()`.  The last stdout line is a JSON
summary with the reference's keys (`decode_tok_per_s` counts the tokens
the decode phase made, `batch * (gen - 1)`).

Example:
    PYTHONPATH=src python -m repro_torch.launch.serve --split \\
        --wire quantize_int8:physical --fused-entry
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --split \\
        --cut 1 --wire quantize_int8:physical --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_130m \\
        --split --wire quantize_int8:physical --prompt-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch recurrentgemma_2b --split --wire quantize_int8:physical \\
        --prompt-len 4096
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3_moe_30b_a3b --split --wire quantize_int8:physical \\
        --fused-entry --prompt-len 128
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch deepseek_v2_236b --reduced --split \\
        --wire quantize_int8:physical --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.serve import ServePlan, ServeSession, resolve_device


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_split(sess: ServeSession, prompt, gen: int) -> dict:
    sess.generate(prompt, gen)                  # warmup (and kernel build)
    _sync(sess.device)

    t0 = time.perf_counter()
    tok0 = sess.prefill(prompt)
    _sync(sess.device)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    rest = sess.decode(tok0, gen - 1)
    _sync(sess.device)
    t_decode = time.perf_counter() - t0

    out = torch.cat([tok0, rest], dim=1)
    B = prompt.shape[0]
    cost = sess.decode_cost(batch=B)
    return {
        "mode": "split", "cut": sess.cut,
        "wire": sess.plan.wire or "dense",
        "fused_entry": sess.plan.fused_entry,
        "prefill_s": t_prefill, "decode_s": t_decode,
        "decode_tok_per_s": B * (gen - 1) / max(t_decode, 1e-9),
        "wire_bytes_per_token": (cost.bytes_up + cost.bytes_down) // B,
        "sample_tokens": out[0, :10].tolist(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4_mini_3_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--split", action="store_true",
                    help="serve across the client/server cut")
    ap.add_argument("--cut", type=int, default=-1)
    ap.add_argument("--wire", default="",
                    help="cut middleware, e.g. quantize_int8:physical")
    ap.add_argument("--fused-entry", action="store_true",
                    help="server entry QKV reads the packed int8 payload")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.split:
        raise SystemExit("monolithic serving is not ported yet; pass --split")
    if args.gen < 2:
        raise SystemExit("--gen must be at least 2 (prefill + decode)")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        # a hybrid model keeps two super-blocks, so the default cut falls
        # on the boundary between them
        cfg = cfg.reduced(vocab=256, **({"n_layers": 2 * len(cfg.pattern)}
                                        if cfg.pattern else {}))
    B = args.batch
    plan = ServePlan(arch=cfg, cut=args.cut if args.cut >= 0 else None,
                     wire=args.wire, max_batch=B,
                     max_len=args.prompt_len + args.gen + 1,
                     fused_entry=args.fused_entry)
    try:
        sess = ServeSession(plan, 0, device=device)
    except ValueError as e:
        raise SystemExit(str(e))
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (B, args.prompt_len),
                           generator=gen, device=device)
    summary = serve_split(sess, prompt, args.gen)
    summary = {"arch": cfg.name, "batch": B, "prompt_len": args.prompt_len,
               "generated": args.gen,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
               **summary}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
