#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit on any error:

1. The card's name and power limit (nvidia-smi), then the build of every
   CUDA kernel from `src/repro_torch/kernels/csrc` (one nvcc per source,
   all at once), with the build seconds and ptxas's register report.
2. Each kernel against its plain torch version on the card, at the
   serving path's shapes (batch 4): the wire quantize and dequantize
   bitwise, the fused q8 entry matmul within the stated tolerance; each
   kernel's median time beside the plain version's, its bound and, where
   one PyTorch call computes the same function, that call's time.
3. The main path: phi4-mini-3.8B at full width (all 32 layers, bf16,
   random weights from a seeded generator), split at layer 4, served
   through `ServeSession` over the physical int8 wire with the fused
   entry: batch 4, prompt 128, 32 generated tokens.  Launch counters are
   zeroed just before and read just after; every kernel must have run,
   the wire must carry the analytic bytes per token, the physical wire's
   tokens must equal the fake wire's, and a reduced model on the card
   must generate what the plain CPU path generates.
4. A `{"kernels": [...]}` line, the card line, and last
   `{"ok": true, "device": {...}}`.

Exits nonzero, printing no result, without a GPU or outside a checkout.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM data-sheet peaks (dense): the bounds below are against these
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}
L2_COPIES = 4                       # 4 x 31.5 MB of W > the 50 MB L2


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fns, *, calls: int = 24, reps: int = 15) -> float:
    """Device time of one call: `calls` back-to-back calls, cycling
    through `fns`, are captured in one CUDA graph, and the median over
    `reps` replays (CUDA events around each) is divided by `calls`.  The
    graph keeps the host's launch overhead out of the number.  Cycling
    through inputs that together exceed the 50 MB L2 makes each call
    find its inputs cold, as the real caller does."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def bound_ms(n_bytes: int, n_ops: float, op_type: str) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _payload(torch, shape, dtype, gen):
    """Normal rows with row scales spread from 0.01 to 50."""
    x = torch.randn(shape, generator=gen, device="cuda")
    rows = x.numel() // shape[-1]
    scales = torch.logspace(-2, torch.log10(torch.tensor(50.0)).item(),
                            rows, device="cuda")
    return (x.reshape(rows, -1) * scales[:, None]).reshape(shape).to(dtype)


def check_wire(torch, gen) -> tuple:
    from repro_torch.core.wire_compress import _fake_quant_int8
    from repro_torch.kernels import ref
    from repro_torch.kernels.wire_quant import wire_dequant, wire_quant

    cases = [((4, 128, 3072), torch.bfloat16), ((4, 1, 3072), torch.bfloat16),
             ((4, 1, 200064), torch.bfloat16), ((4, 1, 3072), torch.float32),
             ((4, 128, 3072), torch.float32)]
    timings = {}
    for shape, dtype in cases:
        x = _payload(torch, shape, dtype, gen)
        q, s = wire_quant(x)
        q_ref, s_ref = ref.wire_quant_ref(x)
        torch.cuda.synchronize()
        if not (torch.equal(q, q_ref) and torch.equal(s, s_ref)):
            n = (q != q_ref).sum().item()
            fail(f"wire_quant {shape} {dtype}: not bitwise equal to the "
                 f"plain version ({n} q elements differ)")
        for out_dtype in {dtype, torch.float32}:
            d = wire_dequant(q, s, out_dtype)
            if not torch.equal(d, ref.wire_dequant_ref(q, s, out_dtype)):
                fail(f"wire_dequant {shape} -> {out_dtype}: not bitwise")
        if not torch.equal(wire_dequant(q, s, dtype), _fake_quant_int8(x)):
            fail(f"dequant(pack(x)) != fake_quant(x) at {shape} {dtype}")
        # the serving path hands these kernels a payload it has just
        # written, so the inputs are timed warm in L2
        tag = f"{tuple(shape)} {str(dtype).replace('torch.', '')}"
        tq = time_ms(torch, [lambda: wire_quant(x)])
        tq_plain = time_ms(torch, [lambda: ref.wire_quant_ref(x)])
        td = time_ms(torch, [lambda: wire_dequant(q, s, dtype)])
        td_plain = time_ms(torch, [lambda: ref.wire_dequant_ref(q, s, dtype)])
        bq = bound_ms(nbytes(x, q, s), 3.0 * x.numel(), "fp32")
        bd = bound_ms(nbytes(q, s) + x.numel() * x.element_size(),
                      1.0 * x.numel(), "fp32")
        print(f"wire_quant   {tag}: bitwise; kernel {tq:.4f} ms, plain "
              f"{tq_plain:.4f} ms, bound {bq[0]:.4f} ms ({bq[1]})")
        print(f"wire_dequant {tag}: bitwise; kernel {td:.4f} ms, plain "
              f"{td_plain:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]})")
        timings[(tuple(shape), dtype)] = (tq, tq_plain, bq, td, td_plain, bd)
    return timings


def _bf16_ulp(torch, ref32):
    mag = ref32.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_splitcat(torch, gen) -> tuple:
    from repro_torch.kernels import ref
    from repro_torch.kernels.splitcat_linear import (
        splitcat_linear_q8, splitcat_linear_q8_plain)
    from repro_torch.kernels.wire_quant import wire_quant

    # the fused entry at decode: one part, bf16 W and output
    x = _payload(torch, (4, 1, 3072), torch.bfloat16, gen)
    q, s = wire_quant(x)
    w = (torch.randn((3072, 5120), generator=gen, device="cuda")
         / 3072 ** 0.5).to(torch.bfloat16)
    y = splitcat_linear_q8([q], [s], w, None, torch.bfloat16)
    y32 = splitcat_linear_q8_plain([q], [s], w, None, torch.float32)
    y16 = splitcat_linear_q8_plain([q], [s], w, None, torch.bfloat16)
    torch.cuda.synchronize()
    err = (y.float() - y32).abs()
    beyond = int((err > _bf16_ulp(torch, y32)).sum())
    if beyond:
        fail(f"splitcat_linear_q8 bf16: {beyond} outputs beyond 1 bf16 ulp "
             "of the fp32-accumulated plain result")
    max_err = (y.float() - y16.float()).abs().max().item()
    n_diff = int((y != y16).sum())
    print(f"splitcat_linear_q8 (4,1,3072)x(3072,5120) bf16: within 1 bf16 "
          f"ulp of the fp32 plain result; against the plain bf16 output "
          f"{n_diff}/{y.numel()} differ, max abs err {max_err:.3e} "
          f"(|y| up to {y32.abs().max().item():.1f})")

    # two parts, ragged width, bias, fp32
    xa = _payload(torch, (4, 3, 3072), torch.float32, gen)
    xb = _payload(torch, (4, 3, 1000), torch.float32, gen)
    (qa, sa), (qb, sb) = wire_quant(xa), wire_quant(xb)
    w2 = torch.randn((4072, 5121), generator=gen, device="cuda") / 64
    b2 = torch.randn((5121,), generator=gen, device="cuda")
    y2 = splitcat_linear_q8([qa, qb], [sa, sb], w2, b2, torch.float32)
    y2_plain = splitcat_linear_q8_plain([qa, qb], [sa, sb], w2, b2,
                                        torch.float32)
    y2_ref = ref.splitcat_linear_q8_ref([qa, qb], [sa, sb], w2, b2)
    torch.cuda.synchronize()
    for name, want in (("plain", y2_plain), ("reference", y2_ref)):
        if not torch.allclose(y2, want, rtol=1e-4, atol=1e-4):
            fail(f"splitcat_linear_q8 2-part fp32 vs {name}: max abs err "
                 f"{(y2 - want).abs().max().item():.3e} (rtol=atol=1e-4)")
    max_err = max(max_err, (y2 - y2_plain).abs().max().item())
    print("splitcat_linear_q8 2 parts (4,3,3072|1000)x(4072,5121)+b fp32: "
          "allclose rtol=atol=1e-4 to plain and reference")

    # at decode the whole model streams through between two entry
    # matmuls, so W is cold: cycle through copies of W that together
    # exceed the L2
    ws = [w] + [w.clone() for _ in range(L2_COPIES - 1)]
    t = time_ms(torch, [lambda wi=wi: splitcat_linear_q8(
        [q], [s], wi, None, torch.bfloat16) for wi in ws])
    t_plain = time_ms(torch, [lambda wi=wi: splitcat_linear_q8_plain(
        [q], [s], wi, None, torch.bfloat16) for wi in ws])
    t_lib = time_ms(torch, [lambda wi=wi: torch.matmul(q.to(wi.dtype), wi) * s
                            for wi in ws])
    b = bound_ms(nbytes(q, s, w, y), 2.0 * 4 * 3072 * 5120, "bf16")
    print(f"splitcat_linear_q8 decode entry: kernel {t:.4f} ms, plain "
          f"{t_plain:.4f} ms, library {t_lib:.4f} ms, bound {b[0]:.4f} ms "
          f"({b[1]}); W cold in L2")
    return max_err, (t, t_plain, t_lib, b)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

B, PROMPT, GEN, CUT, SEED = 4, 128, 32, 4, 0


def main_path(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import ServePlan, ServeSession

    cfg = get_config("phi4_mini_3_8b")
    print(f"main path: {cfg.name} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}, cut {CUT}, "
          f"batch {B}, prompt {PROMPT}, generate {GEN}")
    max_len = PROMPT + GEN + 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = build_model(cfg).init(gen, "cuda")
    torch.cuda.synchronize()
    print(f"init on the card: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    gen.manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                            device="cuda")

    def session(wire, fused):
        return ServeSession(ServePlan(arch=cfg, cut=CUT, wire=wire,
                                      max_batch=B, max_len=max_len,
                                      fused_entry=fused), params,
                            device="cuda")

    fused = session("quantize_int8:physical", True)
    fused.generate(prompts, 2)                   # warmup
    torch.cuda.synchronize()

    ops.reset_launches()
    t0 = time.perf_counter()
    tok0 = fused.prefill(prompts)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    rest = fused.decode(tok0, GEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = ops.launch_counts()
    toks_fused = torch.cat([tok0, rest], dim=1)

    print(f"prefill {t_prefill:.4f} s; decode {GEN - 1} steps "
          f"{t_decode:.4f} s = {B * (GEN - 1) / t_decode:.1f} tok/s; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches on the main path: {launches}")
    want = {"wire_quant": 2 + 2 * (GEN - 1), "wire_dequant": 2 + 2 * (GEN - 1),
            "splitcat_linear_q8": GEN - 1}
    for name, n in want.items():
        if launches[name] == 0:
            fail(f"kernel {name} never launched on the main path")
        if launches[name] != n:
            fail(f"kernel {name}: {launches[name]} launches, expected {n}")

    profile_decode(torch, fused, rest[:, -1:], t_decode / (GEN - 1))
    if tuple(toks_fused.shape) != (B, GEN):
        fail(f"generated shape {tuple(toks_fused.shape)} != {(B, GEN)}")
    if not bool(((toks_fused >= 0) & (toks_fused < cfg.vocab)).all()):
        fail("generated tokens outside the vocabulary")

    per_tok = fused.bytes_per_token()
    cost = fused.decode_cost(batch=B)
    up, down = cfg.d_model + 4, cfg.vocab + 4
    dense = session("", False).bytes_per_token()
    print(f"wire bytes per generated token per row: {per_tok} "
          f"(up {cost.bytes_up // B}, down {cost.bytes_down // B}); "
          f"bf16 wire {dense}")
    if per_tok != up + down or cost.bytes_up + cost.bytes_down != B * per_tok:
        fail(f"wire bytes per token {per_tok} != analytic {up + down}")
    if dense != 2 * (cfg.d_model + cfg.vocab):
        fail(f"bf16 wire bytes per token {dense}")

    phys = session("quantize_int8:physical", False).generate(prompts, GEN)
    fake = session("quantize_int8", False).generate(prompts, GEN)
    if not torch.equal(phys, fake):
        fail("physical-wire tokens differ from fake-wire tokens:\n"
             f"{phys.tolist()}\n{fake.tolist()}")
    shared = int((phys == toks_fused).sum())
    print(f"physical wire == fake wire tokens: bitwise ({B}x{GEN}); the "
          f"fused entry shares {shared}/{B * GEN} tokens with the unfused "
          "physical run")
    del fused, params
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": t_prefill,
            "decode_tok_per_s": B * (GEN - 1) / t_decode,
            "wire_bytes_per_token": per_tok}


def profile_decode(torch, sess, tok, step_s: float, steps: int = 4):
    """Where a decode step's time goes: device kernel time by kernel from
    torch.profiler over `steps` more steps, against the unprofiled wall
    time per step `step_s` (past `max_len` the KV ring wraps, which costs
    the same)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            tok = sess.decode_step(tok)
        torch.cuda.synchronize()
    by_name: dict = {}
    n_kernels = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            n_kernels += 1
    busy_ms = sum(by_name.values()) / 1e3 / steps
    if busy_ms == 0.0:
        print("decode step device time: not measured (the profiler "
              "recorded no device activity)")
        return
    print(f"decode step: wall {step_s * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / (step_s * 1e3):.1f}%), "
          f"{n_kernels / steps:.0f} device kernels per step under "
          f"{len(by_name)} names; top by device time per step:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / steps / 1e3:8.4f} ms  {name[:100]}")


def reduced_against_cpu(torch):
    """A reduced fp32 model served on the card (kernels) and on the CPU
    (plain versions) from the same weights must generate the same
    tokens, for the physical wire with the fused entry."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServePlan, ServeSession

    cfg = get_config("phi4_mini_3_8b").reduced(vocab=97)
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg).init(gen, "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 7), generator=gen)
    plan = ServePlan(arch=cfg, wire="quantize_int8:physical", max_batch=2,
                     max_len=15, fused_entry=True)
    on_cpu = ServeSession(plan, params, device="cpu").generate(prompts, 6)
    on_card = ServeSession(plan, params, device="cuda").generate(prompts, 6)
    if not torch.equal(on_cpu, on_card.cpu()):
        fail(f"reduced model: card tokens {on_card.tolist()} != CPU tokens "
             f"{on_cpu.tolist()}")
    print(f"reduced model, card == CPU plain path: {on_cpu.tolist()}")


# ---------------------------------------------------------------------------

def main():
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("run from the root of a checkout: src/repro_torch not found")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # phase 1: the card and the build
    card = card_line()
    print(f"card: {card}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    seconds = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall, "
          f"per library {seconds}")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # phase 2: kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    wire = check_wire(torch, gen)
    sc_err, (t, t_plain, t_lib, b) = check_splitcat(torch, gen)

    # phase 3: the main path, then the small-input reference check
    run = main_path(torch)
    reduced_against_cpu(torch)

    # phase 4: the record
    kq = wire[((4, 1, 200064), torch.bfloat16)]
    src = "src/repro_torch/kernels/csrc/"
    kernels = [
        {"name": "wire_quant", "route": "cuda", "source": src + "wire_quant.cu",
         "replaces": "src/repro/kernels/wire_quant.py:57",
         "launches": run["launches"]["wire_quant"], "max_abs_err": 0.0,
         "ms": kq[0], "plain_ms": kq[1], "bound_ms": kq[2][0],
         "bound_by": kq[2][1], "library_ms": None},
        {"name": "wire_dequant", "route": "cuda",
         "source": src + "wire_quant.cu",
         "replaces": "src/repro/kernels/wire_quant.py:89",
         "launches": run["launches"]["wire_dequant"], "max_abs_err": 0.0,
         "ms": kq[3], "plain_ms": kq[4], "bound_ms": kq[5][0],
         "bound_by": kq[5][1], "library_ms": None},
        {"name": "splitcat_linear_q8", "route": "cuda",
         "source": src + "splitcat_linear_q8.cu",
         "replaces": "src/repro/kernels/splitcat_linear.py:62",
         "launches": run["launches"]["splitcat_linear_q8"],
         "max_abs_err": sc_err, "ms": t, "plain_ms": t_plain,
         "bound_ms": b[0], "bound_by": b[1], "library_ms": t_lib},
    ]
    print("kernel times above are at the decode step's shapes: wire_quant "
          "and wire_dequant on the (4,1,200064) bf16 logits, "
          "splitcat_linear_q8 on the (4,1,3072) x (3072,5120) bf16 entry")
    print("main path: " + json.dumps(
        {k: v for k, v in run.items() if k != "launches"}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
