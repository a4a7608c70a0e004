"""Serving entry point (port of `repro/launch/serve.py`): prefill, then
greedy decode, monolithic or split.

Monolithic (the default): one teacher-forced `model.prefill` fills the
caches, then `serve.greedy_decode_scan` decodes.  The reference's
`--loop` picks its per-token baseline over its compiled `lax.scan`; the
port's scan already launches one decode step a token, so `--loop` is
accepted and only sets `mode` to "monolithic_loop".

Split (`--split`): the paper's client/server cut at inference time
through `serve.ServeSession`; `--wire quantize_int8:physical` ships the
packed int8 payload up and the quantized logits down, and the summary
reports the metered wire bytes per generated token.

Runs on the GPU unless `--device cpu`.  Every phase runs once for
warmup; timings are fenced by `torch.cuda.synchronize()`.  The last
stdout line is a JSON summary with the reference's keys plus `device`
(`decode_tok_per_s` counts the tokens the decode phase made,
`batch * (gen - 1)`).  Encoder-decoder archs are not ported yet.

Example:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4_mini_3_8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch chatglm3_6b \\
        --reduced --device cpu
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
import dataclasses
import json
import time
from typing import Callable

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.models import build_model
from repro_torch.serve import (ServePlan, ServeSession, greedy_decode_scan,
                               resolve_device)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class ServeRun:
    """What `main` served: its printed summary, every generated token
    (B, gen), and `step`, which decodes one more greedy token (B, 1) ->
    (B, 1) against the run's live caches (to profile a step)."""
    summary: dict
    tokens: torch.Tensor
    step: Callable


@torch.no_grad()
def serve_monolithic(model, params, prompt, gen: int, max_len: int, *,
                     loop: bool = False):
    """One teacher-forced prefill (cache init included) and greedy decode
    of the whole model, every phase warmed up and fenced.  Returns (the
    summary, the (B, gen) tokens, a one-token decode step on the live
    caches).  `loop` only names the mode (see the module docstring)."""
    device = prompt.device

    def prefill():
        cache = model.init_cache(prompt.shape[0], max_len, device)
        logits, cache = model.prefill(params, {"tokens": prompt}, cache)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache

    tok0, cache = prefill()                     # warmup (and kernel build)
    greedy_decode_scan(model, params, cache, tok0, gen - 1)
    _sync(device)

    t0 = time.perf_counter()
    tok0, cache = prefill()
    _sync(device)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    rest, cache = greedy_decode_scan(model, params, cache, tok0, gen - 1)
    _sync(device)
    t_decode = time.perf_counter() - t0

    out = torch.cat([tok0, rest], dim=1)
    B = prompt.shape[0]
    summary = {
        "mode": "monolithic" + ("_loop" if loop else ""),
        "prefill_s": t_prefill, "decode_s": t_decode,
        "decode_tok_per_s": B * (gen - 1) / max(t_decode, 1e-9),
        "sample_tokens": out[0, :10].tolist(),
    }

    def step(tok):
        nonlocal cache
        tok, cache = greedy_decode_scan(model, params, cache, tok, 1)
        return tok
    return summary, out, step


def serve_split(sess: ServeSession, prompt, gen: int):
    """Split prefill + decode through `sess`, warmed up and fenced.
    Returns (the summary, the (B, gen) tokens)."""
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
    }, out


def main(argv=None, *, cfg: ArchConfig | None = None) -> ServeRun:
    """Parse `argv` (default: the command line), serve, print the summary.
    `cfg` replaces the `--arch` config (a caller cuts a model's depth
    with it)."""
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
                    help="cut middleware (split mode), e.g. "
                         "quantize_int8:physical")
    ap.add_argument("--fused-entry", action="store_true",
                    help="server entry QKV reads the packed int8 payload")
    ap.add_argument("--loop", action="store_true",
                    help="the reference's per-token baseline; the port's "
                         "decode is already one step a token, so this "
                         "only sets mode to monolithic_loop")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.gen < 2:
        raise SystemExit("--gen must be at least 2 (prefill + decode)")

    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            # a hybrid model keeps two super-blocks, so the default cut
            # falls on the boundary between them
            cfg = cfg.reduced(vocab=256, **({"n_layers": 2 * len(cfg.pattern)}
                                            if cfg.pattern else {}))
    B = args.batch
    max_len = args.prompt_len + args.gen + 1
    gen = torch.Generator(device=device)
    if args.split:
        plan = ServePlan(arch=cfg, cut=args.cut if args.cut >= 0 else None,
                         wire=args.wire, max_batch=B, max_len=max_len,
                         fused_entry=args.fused_entry)
        try:
            sess = ServeSession(plan, 0, device=device)
        except ValueError as e:
            raise SystemExit(str(e))
        gen.manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (B, args.prompt_len),
                               generator=gen, device=device)
        summary, tokens = serve_split(sess, prompt, args.gen)
        step = sess.decode_step
    else:
        if cfg.encdec:
            raise SystemExit(f"{cfg.name}: encoder-decoder models are not "
                             "ported yet")
        model = build_model(cfg)
        gen.manual_seed(0)          # the weights ServeSession(plan, 0) draws
        params = model.init(gen, device)
        gen.manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (B, args.prompt_len),
                               generator=gen, device=device)
        summary, tokens, step = serve_monolithic(model, params, prompt,
                                                 args.gen, max_len,
                                                 loop=args.loop)
    summary = {"arch": cfg.name, "batch": B, "prompt_len": args.prompt_len,
               "generated": args.gen,
               "device": (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
               **summary}
    print(json.dumps(summary))
    return ServeRun(summary, tokens, step)


if __name__ == "__main__":
    main()
