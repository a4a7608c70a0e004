#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which ends the run with a nonzero exit on any error:

1. The card's name and power limit (nvidia-smi), then the build of every
   CUDA kernel from `src/repro_torch/kernels/csrc` (one nvcc per source,
   all at once), with the build seconds and ptxas's register report.
2. Each kernel against its plain torch version on the card, at the main
   paths' shapes: the wire quantize and dequantize bitwise at every
   payload the paths send, each once (printed with its launches a
   run and launches x (time - bound), beside the launch floor of a
   one-element op), `wire_roundtrip`'s value and gradient bitwise, the
   fused q8 entry matmul (the card tests' other shapes of it, and
   Qwen3-30B-A3B's and InternVL2-2B's entries), the dense splitcat
   entry, rmsnorm at every
   served width (512 to 12,288, prefill and decode rows), the SSD scan
   and flash attention (phi4-mini's causal GQA prefill, RecurrentGemma's
   2048-row window over a 4096-row prompt, DeepSeek-V2's MLA prefill
   with q/k 192 wide and v 128, beside its bound with one and with two
   p v products, Qwen3-30B-A3B's GQA prefill, a group of 8, ChatGLM3's
   group of 16, the reference's qwen1_5_32b MHA 40/40 and
   Mistral-Large's group of 12, InternVL2-2B's 384-row prefill (16 over
   8), Whisper-base's decoder prefill and, non-causal, its encoder over
   1,500 frames (fp32 and bf16, against SDPA with is_causal=False), and
   phi4-mini's long-context prefill (12,288 rows within its 8,192-row
   window, held in query blocks, beside SDPA with the window mask), and
   the examples' training attention:
   the 100M driver's 8 over 4 heads of 64 at seq 128, quickstart's 4
   over 2 of 32 at seq 32; the multimodal example's (64,20)|(64,20) x
   (40,4) + b splitcat entry; rmsnorm at their widths 512 and 128)
   within the stated tolerances; each kernel's median
   time beside the plain version's, its bound and, where one PyTorch call
   computes the same function, that call's time; rmsnorm's rows 0-3
   bitwise the same among 1, 4, 8 and 512 rows at every width.  Then the
   training gradient of rmsnorm, flash attention and the SSD at the LM
   training shapes and the examples' (fp32, every input requiring grad:
   rmsnorm (16,128,512) and (8,32,128), flash q (16,128,8,64) k/v
   (16,128,4,64) and q (8,32,4,32) k/v (8,32,2,32)): one kernel launch
   and a grad_fn, rmsnorm's two backward kernels (bitwise the same on a
   second call; timed alone beside their bound) and no launch in flash's
   or the SSD's backward, and the plain version's autograd gradients
   within rtol 1e-5; the backward timed beside `F.rms_norm`'s and
   `scaled_dot_product_attention`'s.  The same in bf16 at the
   training CLI's shapes (batch 8 x seq 512, RecurrentGemma's windowed
   attention, the SSD at chunk 256 and 64, and Whisper's non-causal
   encoder attention (8,1500,8,64)), within rtol 2**-7.
3. Serving: phi4-mini-3.8B at full width (all 32 layers, bf16, random
   weights from a seeded generator), split at layer 4, served through
   `ServeSession` over the physical int8 wire with the fused entry:
   batch 4, prompt 128, 32 generated tokens.  Launch counters are zeroed
   just before and read just after; every kernel of the path must have
   run as often as the code implies (rmsnorm too, and flash attention
   once per layer at prefill), the wire
   must carry the analytic bytes per token, the physical wire's tokens
   must equal the fake wire's, and a reduced model on the card must
   generate what the plain CPU path generates.
3b. Training: the vertical (multi-modal) split of two VGG-16 branches
   (13 convs + FC1 each, full width, fp32, random weights from a seeded
   generator) into a dense trunk, `Plan(mode="vertical")` with AdamW
   over the physical int8 wire, 128 rows per modality, 30 rounds of
   `Session.fit` with launch counters zeroed just before and read after
   the rounds and the fused evaluation.  The loss must fall and the
   evaluation accuracy exceed three times chance, each round must launch
   the wire kernels 4 times each and bill 264,192 wire bytes, the fused
   splitcat evaluation must match the concat trunk, the physical wire
   must train bitwise like the fake wire, and a reduced model trained on
   the card must match the plain CPU path.
3c. SSM serving: Mamba2-130M at full width (24 layers, d_model 768,
   24 SSD heads of 64, state 128, dense conv 4 x 1792 x 1792, vocab
   50,280, tied head, bf16, random weights from a seeded generator),
   split at layer 4 over the physical int8 wire: batch 4, prompt 512 (two
   chunks of 256), 32 generated tokens.  Launch counters are zeroed just
   before and read just after; every launch count must equal what the
   code implies (rmsnorm 49 per forward, ssd_scan once per layer at
   prefill, the wire kernels twice per forward), the wire must bill
   772 + 50,284 B per token per row, the physical wire's tokens must
   equal the fake wire's, and a reduced SSM model on the card must
   generate what the plain CPU path generates at a prompt that is not a
   multiple of the chunk.  The profiler reads a decode step and the
   prefill.
3d. Hybrid serving: RecurrentGemma-2B at full width (26 layers as
   (rglru, rglru, attn) x 8 + (rglru, rglru), d_model 2560, lru_width
   2560, 10/1 heads of 256 with a 2048-row window, gelu MLP 7680, vocab
   256,000 untied, bf16, random weights from a seeded generator), split
   at layer 3 over the physical int8 wire: batch 4, prompt 4096 (twice
   the window), 32 generated tokens.  Every launch count must equal what
   the code implies (flash attention once per attention layer at
   prefill, rmsnorm 53 per forward, the wire kernels twice per forward),
   the wire must bill 2,564 + 256,004 B per token per row, the physical
   wire's tokens must equal the fake wire's, and a reduced hybrid model
   on the card must generate what the plain CPU path generates at a
   prompt past its window and no multiple of the kernel's tiles.
3e. Vanilla training: VGG-16 at full width (13 convs + FC1 + FC2,
   14,982,474 parameters, fp32, random weights from a seeded generator)
   cut after its second conv (the paper's Table 1 setup), 4 clients
   round-robin with the p2p weight handoff, `Plan(mode="vanilla")` with
   AdamW over the physical int8 wire, 128 rows per client per turn, 30
   rounds (120 turns) of `Session.fit` with launch counters zeroed just
   before and read just after.  The loss must fall and every client's
   evaluation accuracy reach three times chance; `wire_report` must bill
   8,912,896 B up and the same down a turn, all physical, and the meter
   41,140 B a handoff on top (`client_gb` exact, client 0 one handoff
   short); the wire kernels must launch 716 times each (2 a turn at the
   cut, 4 leaves a handoff); the physical wire must train bitwise like the
   fake wire, and a reduced model trained on the card must match the plain
   CPU path.
3f. The label-private and relay topologies, as 3e: `Plan(mode=
   "u_shaped", cuts=(2, 19))` (the client keeps conv 1-2 and FC2 with the
   loss; 8,912,896 + 66,048 B up and the same down a turn, 48,322 B a
   handoff, 1,194 launches of each wire kernel) and `Plan(mode=
   "multihop", cuts=[2, 7])` (8,912,896 B each way a turn billed, the
   relay's (128,8,8,256) crossing unbilled, 956 launches of each).
3g. Configuration (ii) on the vertical slice's two VGG-16 branches, 30
   rounds of 128 rows: `multitask` with two 1024 -> 10 heads (task 1's
   labels (labels + 1) % 10; each task's accuracy above three times
   chance) and `extended_vanilla` with a 1024 -> 512 ReLU mid client and
   a 512 -> 10 trunk; each bills 264,192 B a round (the mid client's
   66,048 B each way unbilled) and launches each wire kernel 4 (6) times
   a round. Both train 30 more rounds before their accuracy check
   (`EXTRA_ROUNDS`: at round 30 they are mid-way up their learning
   curves).
3h. The paper's comparison: `fedavg` (2 local steps) and `large_batch`
   over full-width VGG-16, 4 clients of 128 rows, 30 rounds; the model
   pulled and pushed through the physical wire at 15,120,370 B (59,929,896
   B dense), so each client is billed 30,240,740 B a round and each wire
   kernel launches 60 times a round; the global model's accuracy above
   three times chance.  Then the measured client TFLOPs and GB of
   splitNN (3e), fedavg and large_batch beside `paper_table1_setup(4)`'s
   analytic rows; splitNN's client TFLOPs must be below large_batch's.
   Every path of 3e-3i: the loss falls, bytes and launches exact, a round's
   time from CUDA events and a profiled round's device busy time, physical
   == fake bitwise over 3 rounds (deterministic cuDNN), and the reduced
   SMOKE model on the card == the plain CPU path over 3 rounds.
3i. The schedules, on the same models, data and wire: the three turn
   kinds under `schedule="parallel"` (SplitFed: every client against one
   server, which steps on the mean cut gradient; each client billed a
   turn's cut bytes a round and no handoff; every client's accuracy above
   three times chance; 240 / 480 / 480 launches of each wire kernel), and
   every mode under `schedule="pipelined", microbatches=2` (each turn or
   round streamed through the cut as two 64-row microbatches: the turn
   kinds' meter equal to their round-robin meter byte for byte and 956 /
   1,674 / 1,436 launches; the branch kinds 264,192 B a round and 240 /
   240 / 360 launches; the baselines' wire unchanged, 1,800 launches),
   each beside its own schedule's time a round; then vanilla pipelined at
   M=1 against round-robin over the same batches: losses, state and meter
   bitwise under deterministic cuDNN.
3j. LM split training, `Plan(mode="vanilla", model=lm_split_fns(model,
   cut))` over the physical wire, fp32, AdamW(1e-4), random weights from a
   seeded generator, batch 4 x seq 512 a turn of `lm_batch` tokens drawn
   from the first 1,024 ids, 30 rounds: Mamba2-130M at full width (d 768,
   the dense conv) cut to 12 of its 24 layers, cut 4, 2 clients
   round-robin with the p2p handoff; and phi4-mini at full width (d 3072,
   24/8 heads of 128, SwiGLU 8192, vocab 200,064, tied) cut to 2 of its 32
   layers (with their gradients and AdamW moments, and the tied table
   held by the client and by the server, 32 layers would not fit one 80
   GB card), cut 1, 1 client.  Both depths keep the whole run inside its
   time limit.  Each: the loss falls,
   `wire_report` bills 4 x 512 x (d + 4) B each way a turn, Mamba2's
   handoff the analytic sum over its client's 37 leaves (105,380,640 B)
   with `client_gb` exact, launches exact (rmsnorm 25 and ssd_scan 12 a
   Mamba2 forward, rmsnorm 5 and flash_attention 2 a phi4-mini one,
   rmsnorm_bwd 2 an rmsnorm in backward and nothing else there, the wire
   kernels 2 a turn plus the handoff's leaves),
   physical == fake bitwise over 3 rounds under deterministic algorithms,
   a round's time and one profiled round.  Then Mamba2 over 3 rounds
   pipelined at M=2 (its meter equal to round-robin's over the same 3
   rounds, the client forward twice a microbatch), in parallel, and as
   `large_batch` over `FullFns` (the 110 leaves' pull and push); and reduced phi4-mini, Mamba2 and RecurrentGemma (a sequence
   past its window) trained on the card == the plain CPU path over 3
   rounds.
3k. The training CLI, `repro_torch.launch.train.main(argv)` in-process
   (its JSON line parsed, launch counters zeroed just before and read just
   after), in each config's own bf16 with the CLI's AdamW(1e-3, decay
   0.01), batch 8 a client, ids below 1,024: Mamba2-130M at 12 of its 24
   layers, split
   over 2 clients at seq 512 with `--wire quantize_int8:physical,
   dp_noise:0.05` for 30 steps with `--ckpt`, then 3 steps each under
   `--schedule parallel`, `pipelined --microbatches 2`, at the default
   seq 64 (one 64-row SSD chunk), and as `--mode monolithic`, `fedavg
   --local-steps 2` and `large_batch`; RecurrentGemma-2B cut to 8 of its
   26 layers (in bf16 with AdamW all 26 need about 77 GB of state before
   activations), split over 1
   client at seq 512 over the physical wire for 30 steps.  Each: launches
   exact (dp_noise re-packs each crossing: 2 quantizes and 2 dequantizes),
   `wire_report` and `client_gb` exact, the final loss below the first on
   the 30-step runs, the checkpoints restoring bitwise on the card, ms a
   round and a profiled round, the peak; physical == fake bitwise over 3
   steps (no dp_noise) under deterministic algorithms for both models;
   the CLI as its own process (`python -m repro_torch.launch.train`); and
   phi4-mini, whose 32 layers do not fit one card, `--reduced` through
   the CLI on the card against the CPU.
   Then ResNet-CIFAR100 (stages (3,4,6,3), widths 64-512, 100 classes,
   fp32) vanilla at cut 2, 4 clients round-robin with the p2p handoff,
   batch 128, AdamW(1e-4), the physical wire, 30 rounds: the loss falls,
   every client's accuracy above 3x chance, 8,912,896 B each way a turn
   and 80,376 B a handoff with `client_gb` exact, 954 launches of each
   wire kernel, physical == fake bitwise, SMOKE card == CPU.
3l. MoE serving: Qwen3-30B-A3B at full width and depth (48 GQA + MoE
   layers, 32/4 heads of 128, 128 experts of 768 top-8, vocab 151,936,
   30.5B parameters, bf16, random weights from a seeded generator), cut
   4 over the physical wire with the fused q8 entry, batch 4, prompt
   128, 32 tokens: launches exact (flash 48, rmsnorm 3,073, the q8 entry
   31, the wire kernels 64), 2,052 + 151,940 B per token per row,
   physical == fake tokens bitwise, a profiled decode step and prefill
   with the device time inside the MoE layers and inside attention (each
   above 0), the serving peak (init's apart), and a reduced model on the
   card == the CPU at a prompt where experts overflow their capacity
   (`moe_apply(..., return_aux=True)`'s drop fractions on each prefill
   MoE layer's input, card and CPU, printed and above 0).
3m. The same for DeepSeek-V2 at full width cut to 8 of its 60 layers
   (MLA with 128 heads of 128 + 64 / v 128, a dense first layer, then
   MoE with 2 shared and 160 routed experts top-6), cut 4, no fused
   entry (an MLA entry refuses it): flash 8 at (192, 128), rmsnorm
   1,056, 5,124 + 102,404 B per token per row; the reduced model's MLA
   at the kernel's (64, 32) pair.
3n. Monolithic serving, the serve CLI's default mode, in-process
   (`repro_torch.launch.serve.main(argv)`, its JSON line parsed, launch
   counters zeroed just before and read just after; bf16 weights from
   the CLI's seed; batch 4, prompt 128, 32 tokens): phi4-mini whole, its
   tokens bitwise those of a split `ServeSession` over the dense wire at
   cut 4; rmsnorm 2·32·(2L+1) and flash 2L launches a run (warmup and
   timed run), no wire kernel.  Then ChatGLM3-6B and the reference's
   scaled qwen1_5_32b (MHA 40/40, not the published GQA 40/8) whole and
   Mistral-Large-123B cut to the
   deepest depth that leaves 8 GiB of the card free: prefill s, decode ms
   a step and tok/s, a profiled step's busy share and kernels, the peak.
3o. Continuous batching: phi4-mini at full width cut to 8 of its 32
   layers, split at 4 over the physical
   wire with the fused entry, a `Batcher` of 8 slots serving a queue of
   12 tenants (seeded prompts of 16-256 tokens, 8-48 new tokens each),
   seated while a slot is free after every step: the bytes exactly
   sum_t [S_t (3072+4) + (200064+4) + (n_t-1) 203,144], the launches
   exactly as the code implies per join and per step (one quantize a
   live tenant, the q8 entry and the stacked payload's dequantize, the
   logits both ways, the pad row's quantize once a run), row
   independence bitwise (random packed pad rows leave every live token
   and live cache row unchanged), each tenant against its solo B=1
   `ServeSession` (the first token exactly; then, with the solo tokens
   forced as every tenant's inputs, every step's logits within 5% of the
   solo top logit, and the token the solo one wherever the measured
   difference and an int8 level cannot move the argmax; the counted run
   equal to the forced run while its tokens are the solo ones),
   tok/s and a full step's busy share; reduced fp32 phi4-mini (fused),
   Mamba2, RecurrentGemma (its window wrapping per row) and DeepSeek-V2
   (MLA per row) under one join schedule, card == CPU token for token.
3p. The paper's results and the examples: `repro_torch.launch.
   paper_tables.main(["--full"])` in-process, Tables 1-2 as
   `table{1,2}_rows` give them (the CPU tests hold those to the
   reference's), and Fig. 3 over
   the paper's VGG-16 (10 classes, 4 clients of 128 rows, AdamW 1e-4,
   30 rounds through the deprecated shims, a point every 5 rounds on 256
   held-out rows): each method's client TFLOPs strictly rising and equal
   to 3 x `vgg16_flops_per_sample` x the rows seen (cut 2 for splitNN),
   splitNN's below both baselines' at every point, fedavg's equal to
   large_batch's, every final accuracy at least `FIG3_MIN_ACC`'s (set
   from `chip_spread.py fig3`); no kernel launched.  Then each
   `examples/torch_*.py`'s `main()` at the reference's sizes, its own
   asserts passing, launch counters zeroed just before and read just
   after: quickstart (reduced phi4-mini, 60 steps) and the 100M driver
   (12 layers of d 512, 300 steps, fp32) launch rmsnorm 2L+1, rmsnorm_bwd
   2 x that and flash L a step exactly, the multimodal example one
   splitcat_linear (its fused evaluation, equal to `Session.evaluate`'s
   accuracy), multi-hop none; wall seconds and tokens/s printed.
3q. VLM serving: InternVL2-2B whole (24 layers, 1.89B parameters, bf16,
   seeded weights) split at 4 over the physical wire with the fused
   entry, batch 4, 256 seeded patches (4,256,1024) and a 128-token
   prompt a request, 32 tokens: exactly 2,052 + 92,557 B a token a row
   and 384 x 2,052 up and 92,557 down a row at prefill, the records the
   real prefill and decode step bill equal to `prefill_cost(...,
   extra)` and `decode_cost`'s; launches exact (flash 24 at the 384-row
   shape, rmsnorm 49 + 31 x 48, the q8 entry 31, the wire 64 each);
   physical == fake and monolithic (`LM.prefill` with the patches, then
   `greedy_decode_scan`) == the split dense-wire session, bitwise;
   prefill s, decode ms a step, tok/s, a profiled step's busy share,
   the peak.  Then a `Batcher` of 4 slots serving 6 seeded tenants
   (prompts 16-128, 8-32 tokens, each its own patches): bytes exactly
   sum_t [(256 + S_t) 2,052 + 92,557 + (n_t - 1) 94,609], tokens and
   launches exact, each first token its solo B=1 stream's; a reduced
   VLM card == CPU.
3r. Encoder-decoder serving and both families in the training CLI:
   Whisper-base whole (6 + 6 layers, d 512, 1,500 frames, 70.7M
   parameters, bf16) through the serve CLI in-process (batch 4, prompt
   64, 32 tokens): its JSON line, exactly 6 non-causal and 6 causal
   flash launches a prefill (the calls counted by mode), no rmsnorm and
   no wire kernel, the generated tokens against `decode_full` re-run
   teacher-forced over them (logits within 5% of the top one), and in
   fp32 at full size the reference's prefill == decode-loop test (1e-4)
   and the same teacher-forced check; a reduced Whisper card == CPU.
   Then the training CLI in bf16, batch 8, 64 text tokens of ids below
   1,024: Whisper-base monolithic 30 steps, fedavg and large_batch 3
   each, InternVL2-2B (256 patches) monolithic 30 steps at the deepest
   depth leaving 8 GiB free (all 24 layers on an 80 GB card): launches
   exact, the loss falling, the peak; `--mode split` refused for both.
3s. The fleet (`Plan(fleet=FleetSpec(n_devices=1))`: the clients
   sharded over the ranks of a process group, here an NCCL group of one
   rank on the card, destroyed at the end of the phase): Table 1's
   setup of 3e-3h (VGG-16, 4 clients of 128 rows, the physical wire,
   AdamW 1e-4) for 3 rounds each of vanilla round-robin with the p2p
   handoff, vanilla parallel, fedavg and large_batch, each bitwise the
   single-device `Session` from the same seed and data under
   deterministic cuDNN (losses, the gathered state, the meter, the wire
   report, every client's accuracy), launches exact (68, 24, 180, 180
   of each wire kernel), ms a round of both (CUDA events) and the NCCL
   collective calls a round; then the training CLI's Mamba2-130M split
   over 2 clients, parallel, bf16, 3 steps with `--fleet`, its JSON line
   equal to the run's without it under deterministic algorithms.
3t. The sharded serving paths at one rank, over a one-rank NCCL mesh
   (`make_mesh_compat((1, 1), ("data", "model"))`, destroyed at the end
   of the phase): (a) Qwen3-30B-A3B served whole as phase 3l serves it,
   with `ep_axis="model"` on its 48 MoE layers, in turns with the
   single-device path from the same weights: tokens and wire bytes
   bitwise, launches exactly phase 3l's, 48 all_reduces a forward, decode
   ms a step of both; (b) one of its MoE layers at full width, fp32, T =
   8 x 512: the output and every gradient of the EP path bitwise the
   single-device path's under deterministic algorithms; (c) split-KV
   decode at qwen1_5_32b's attention (d 5,120, MHA 40/40 of 128, qkv
   bias), fp32, batch 4, a 32,768-row ring of seeded rows from pos
   32,760 for 16 steps across the wrap: each step within 1e-5 of the
   native decode's largest output; (d) the int8 KV cache at the same
   layer in bf16: its bytes exactly 2·B·L·K·(hd + 4), each step within 5%
   of the native output's largest value, every decoded row's q and scale
   bitwise the CPU's; ms a step of each beside native.  Then (e)
   Qwen3-30B-A3B (3 layers, 1 client), DeepSeek-V2 (1, 1) and
   ChatGLM3-6B (5, 2) trained by the CLI in-process (bf16, AdamW 1e-3,
   batch 8 x seq 512, split, the physical wire, 30 steps), each the
   deepest depth leaving 8 GiB free, over 2 clients where one layer does:
   the JSON line's wire_report and client_gb exact, launches exact, the
   loss falling, ms a step and the peak.
3u. The long-context variant and the dry run's step functions: (a)
   phi4-mini whole (32 layers, bf16) built with `long_context=True`
   (every attention within its 8,192-row window, a ring of 8,192 rows):
   the long_500k cache (B=1, max_len 524,288) held at exactly
   1,073,741,824 B, 64x less than without the window; one 12,288-token
   prompt (ids below 1,024) prefilled (32 flash launches in window mode)
   and 32 greedy steps over the wrapped ring, launches exact; at 8,192
   tokens, where the window does not bind, the first token the normal
   model's and the prefill logits within 5% of its top logit; then 2
   layers at full width (fp32, window 64, a 96-token prompt, 48 steps)
   card == CPU token for token.  (b) `launch.dryrun`'s train, prefill and
   serve steps for real on a (1, 1) ("data", "model") `DeviceMesh` over
   a one-rank NCCL group, the params laid out by `param_shardings`
   through `distribute_tensor` (each local shard the spec's shape): the
   train step (the loss with remat, clip 1.0, AdamW 3e-4) on phi4-mini
   at full width, B=1 x S=4,096, at the deepest depth leaving 8 GiB free
   (the peak measured at 1 and 2 layers, linear in depth), 3 steps: the
   loss falls, launches exact (rmsnorm and flash forward and again in
   remat's recompute, rmsnorm's backward kernels), the peak leaves 8 GiB;
   the dry run's per-device argument bytes at (1, 1) equal the bytes
   held; the prefill and serve steps once; remat against none at 4
   layers bitwise (loss and every gradient, deterministic algorithms).
   Each phase's wall seconds are printed on a line of its own.
4. A `{"kernels": [...]}` line, the card line, and last
   `{"ok": true, "device": {...}}`.

Exits nonzero, printing no result, without a GPU or outside a checkout.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM data-sheet peaks (dense): the bounds below are against these
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}
L2_BYTES = 50 * 2 ** 20             # the H100 SXM's L2
L2_COPIES = 4                       # 4 x 31.5 MB of W > the 50 MB L2
# kernels one rmsnorm backward call launches when x and scale both need a
# gradient (kernels/rmsnorm.py: rmsnorm_bwd_rows, then rmsnorm_bwd_cols)
RMS_BWD_KERNELS = 2


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

def time_ms(torch, fns, *, calls: int = 24, reps: int = 15,
            keep: bool = False) -> float:
    """Device time of one call: `calls` back-to-back calls, cycling
    through `fns`, are captured in one CUDA graph, and the median over
    `reps` replays (CUDA events around each) is divided by `calls`.  The
    graph keeps the host's launch overhead out of the number.  Cycling
    through inputs that together exceed the 50 MB L2 makes each call
    find its inputs cold, as the real caller does; with `keep`, every
    call's output stays allocated while the graph lives, so no call
    writes where an earlier one did and found it in L2 (`cold_copies`)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    kept = []
    with torch.cuda.graph(graph):
        for i in range(calls):
            out = fns[i % len(fns)]()
            if keep:
                kept.append(out)
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
    del graph, kept
    return statistics.median(times)


def cold_copies(n_bytes: int, most: int = 64) -> int:
    """Copies of a call's inputs that, cycled through by `time_ms` with
    `keep`, move more than the L2 holds between two uses of one copy, for
    a call that moves `n_bytes`; 0 where that takes more than `most`
    copies (a decode row: a few KB, bound by the launch, timed warm)."""
    k = 1 + L2_BYTES // n_bytes
    return k if k <= most else 0


def bound_ms(n_bytes: int, n_ops: float, op_type: str) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def versus(t, t_lib, bd) -> str:
    """The kernel's time against the library call's and its share of the
    bound."""
    lib = f"{t / t_lib:.2f}x the library" if t_lib else "no library call"
    return f"{lib}, {bd[0] / t:.1%} of the bound"


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


def wire_payloads(torch) -> list:
    """Every payload the main paths hand the wire kernels, with the
    launches per run that the code implies: (path, crossing, shape,
    dtype, (quantize launches, dequantize launches)).  A prefill sends the prompt's
    activations up and the last position's logits down
    (`serve/split_infer.py`), a decode step one row each way, a vertical
    or multitask training round two feature payloads up and two gradients
    down (extended_vanilla adds the mid client's activation and
    gradient), a turn every crossing of its kind once (vanilla the cut
    both ways, u_shaped both cuts both ways, multihop the cut and the
    relay hop both ways), and every handoff but none before the first
    turn the client's leaves (two conv weights, two biases; u_shaped also
    FC2's weight and bias).  A fedavg or large_batch round pulls every
    VGG-16 leaf and pushes each stacked over the 4 clients.  Under the
    parallel schedule a turn kind has no handoff; under the pipelined one
    every crossing is sent once a microbatch, at half the rows.  Two fp32
    cases on no path close the list."""
    from repro_torch.configs import get_config

    out = []
    for path, arch, b, prompt, gen in (
            ("serving", "phi4_mini_3_8b", B, PROMPT, GEN),
            ("training", None, 0, 0, 0),
            ("ssm_serving", "mamba2_130m", SB, SPROMPT, SGEN),
            ("hybrid_serving", "recurrentgemma_2b", HB, HPROMPT, HGEN),
            *((run.path, arch, B, PROMPT, GEN)
              for arch, run in MOE_RUNS.items()),
            (EP_PATH, EP_ARCH, B, PROMPT, GEN)):
        if arch is None:
            out.append((path, "up (features) / down (gradients)", (TB, 512),
                        torch.float32, (4 * ROUNDS,) * 2))
            continue
        cfg = get_config(arch)
        out += [(path, "prefill up", (b, prompt, cfg.d_model), cfg.dtype,
                 (1, 1)),
                (path, "decode up", (b, 1, cfg.d_model), cfg.dtype,
                 (gen - 1,) * 2),
                (path, "down (logits)", (b, 1, cfg.vocab), cfg.dtype,
                 (gen, gen))]
    out += [p for mode in TURN_KINDS for p in _turn_payloads(torch, mode)]
    out += [p for mode in ("multitask", "extended_vanilla")
            for p in _branch_payloads(torch, mode)]
    out += [p for mode in BASELINES
            for p in _baseline_payloads(torch, mode)]
    # phase 3i: the other schedules, at the microbatch payloads
    out += [p for mode in TURN_KINDS for sched in ("parallel", "pipelined")
            for p in _turn_payloads(torch, mode, sched)]
    out += [p for mode in BRANCH_RECORDS
            for p in _branch_payloads(torch, mode, "pipelined")]
    out += [p for mode in BASELINES
            for p in _baseline_payloads(torch, mode, "pipelined")]
    # phase 3j: the LM paths' cut, handoff and model payloads
    out += _lm_payloads(torch)
    # phase 3k: the CLI's bf16 cut (twice under dp_noise) and handoff
    # payloads, and ResNet's cut and handoff
    out += _cli_payloads(torch)
    out += _resnet_payloads(torch)
    # phase 3o: the Batcher's joins, client rows, stacked payloads
    out += bat_payloads(torch)
    # phase 3q: the VLM's split session and Batcher
    out += vlm_payloads(torch)
    # phase 3s: the fleet's VGG-16 rounds and its CLI run
    out += fleet_payloads(torch)
    # phase 3t: EP serving (above, as phase 3l's) and the CLI's MoE and
    # dense training runs
    out += t_payloads(torch)
    out += [(None, "no path", (4, 1, 3072), torch.float32, (0, 0)),
            (None, "no path", (4, 128, 3072), torch.float32, (0, 0))]
    return out


def path_name(mode: str, schedule: str | None = None) -> str:
    """A training path's name: `{mode}_training` under the mode's own
    schedule, `{mode}_{schedule}_training` under another."""
    return f"{mode}_{schedule}_training" if schedule else f"{mode}_training"


def _turn_payloads(torch, mode: str, schedule: str | None = None, *,
                   rounds: int | None = None, path: str | None = None) -> list:
    """A turn kind's wire payloads over `rounds` rounds: every crossing of
    its turn once a microbatch (M under the pipelined schedule, of rows /
    M), and unless the schedule is parallel the client's leaves at every
    handoff taken (every turn but the first).  `path` names a path other
    than the mode's own (phase 3s's fleet)."""
    spec, m = TURN_KINDS[mode], MICROBATCHES.get(schedule, 1)
    turns, f32 = V_CLIENTS * (rounds or V_ROUNDS), torch.float32
    path = path or path_name(mode, schedule)
    by_shape: dict = {}
    for name, direction, shape, _, _ in spec["report"]:
        by_shape.setdefault((shape[0] // m,) + shape[1:], []).append(
            f"{name} {direction}")
    out = [(path, " / ".join(names), shape, f32,
            (len(names) * m * turns,) * 2)
           for shape, names in by_shape.items()]
    if schedule != "parallel":
        out += [(path, f"handoff {leaf}", shape, f32,
                 (k * (turns - 1),) * 2)
                for leaf, shape, k in spec["handoff_leaves"]]
    return out


def _branch_payloads(torch, mode: str,
                     schedule: str | None = None) -> list:
    """A branch kind's feature payloads up and gradients down (and the
    mid client's), once a microbatch of a round."""
    m = MICROBATCHES.get(schedule, 1)
    return [(path_name(mode, schedule), "branches (and mid client) up / "
             "down", (TB // m, 512), torch.float32,
             (len(BRANCH_RECORDS[mode]) * m * ROUNDS,) * 2)]


def _baseline_payloads(torch, mode: str, schedule: str | None = None, *,
                       rounds: int | None = None,
                       path: str | None = None) -> list:
    """Every VGG-16 leaf pulled, and pushed stacked over the clients, once
    a round: the microbatches do not cross the wire."""
    f32, out, rounds = torch.float32, [], rounds or V_ROUNDS
    path = path or path_name(mode, schedule)
    for shape, k in _vgg16_leaf_shapes().items():
        out += [(path, "model pull", shape, f32, (k * rounds,) * 2),
                (path, "model push", (V_CLIENTS,) + shape, f32,
                 (k * rounds,) * 2)]
    return out


def _vgg16_leaf_shapes() -> dict:
    """VGG-16's leaf shapes (HWIO convs, (in, out) dense) -> how many
    leaves have each."""
    from collections import Counter

    from repro_torch.configs.vgg_cifar10 import CONFIG

    shapes, ch = [], CONFIG.in_ch
    for item in CONFIG.plan:
        if item != "M":
            shapes += [(3, 3, ch, item), (item,)]
            ch = item
    shapes += [(ch, 512), (512,), (512, CONFIG.n_classes),
               (CONFIG.n_classes,)]
    return dict(Counter(shapes))


def check_wire(torch, gen) -> tuple:
    """The wire kernels bitwise against the plain versions (and dequant
    of the pack against the fake quantizer) at every payload of
    `wire_payloads`, each kernel's time beside the plain version's, its
    bound and its launches per run; the launch floor; `wire_roundtrip`'s
    value and gradient bitwise.  Returns ({(shape, dtype): timings},
    the payload list)."""
    from repro_torch.core.wire_compress import _fake_quant_int8
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.wire_quant import (wire_dequant, wire_quant,
                                                wire_roundtrip)

    # five payloads draw from `gen`, in a fixed order, so the checks after
    # this one see fixed inputs; the training payloads and the rest have
    # generators of their own
    first = {((4, 128, 3072), torch.bfloat16), ((4, 1, 3072), torch.bfloat16),
             ((4, 1, 200064), torch.bfloat16), ((4, 1, 3072), torch.float32),
             ((4, 128, 3072), torch.float32)}
    vanilla = torch.Generator(device="cuda").manual_seed(64)
    lm = torch.Generator(device="cuda").manual_seed(768)
    own = {(128, 512): torch.Generator(device="cuda").manual_seed(512),
           **{shape: vanilla for path, _, shape, _, _ in wire_payloads(torch)
              if path == "vanilla_training"},
           **{shape: lm for _, _, shape, _, _ in _lm_payloads(torch)}}
    rest = torch.Generator(device="cuda").manual_seed(17)
    one = torch.zeros(1, device="cuda")
    two = torch.zeros(1, device="cuda")
    floor = time_ms(torch, [lambda: torch.add(one, 1, out=two)])
    print(f"launch floor: {floor:.4f} ms (a one-element torch.add in the "
          f"same CUDA-graph harness)")
    payloads = wire_payloads(torch)
    # a payload several paths send is checked and timed once
    uses: dict = {}
    for path, crossing, shape, dtype, n in payloads:
        uses.setdefault((tuple(shape), dtype), []).append((path, crossing, n))
    timings, gaps = {}, {"wire_quant": 0.0, "wire_dequant": 0.0}
    for (shape, dtype), sent in uses.items():
        nq = sum(k[0] for _, _, k in sent)
        nd = sum(k[1] for _, _, k in sent)
        g = gen if (shape, dtype) in first else own.get(shape, rest)
        x = _payload(torch, shape, dtype, g)
        q, s = wire_quant(x)
        q_ref, s_ref = ref.wire_quant_ref(x)
        torch.cuda.synchronize()
        if not (torch.equal(q, q_ref) and torch.equal(s, s_ref)):
            bad = (q != q_ref).sum().item()
            fail(f"wire_quant {shape} {dtype}: not bitwise equal to the "
                 f"plain version ({bad} q elements differ)")
        for out_dtype in {dtype, torch.float32}:
            d = wire_dequant(q, s, out_dtype)
            if not torch.equal(d, ref.wire_dequant_ref(q, s, out_dtype)):
                fail(f"wire_dequant {shape} -> {out_dtype}: not bitwise")
        if not torch.equal(wire_dequant(q, s, dtype), _fake_quant_int8(x)):
            fail(f"dequant(pack(x)) != fake_quant(x) at {shape} {dtype}")
        # the serving path hands these kernels a payload it has just
        # written, so the inputs are timed warm in L2 (the 126 MB prefill
        # payload of RecurrentGemma is cold by its size)
        tag = (f"{tuple(shape)} {str(dtype).replace('torch.', '')} ("
               + "; ".join(f"{path or '-'} {crossing} x{k[0]}/{k[1]}"
                           for path, crossing, k in sent) + ")")
        tq = time_ms(torch, [lambda: wire_quant(x)])
        tq_plain = time_ms(torch, [lambda: ref.wire_quant_ref(x)])
        td = time_ms(torch, [lambda: wire_dequant(q, s, dtype)])
        td_plain = time_ms(torch, [lambda: ref.wire_dequant_ref(q, s, dtype)])
        # one PyTorch call computing the dequantize, where it is bitwise
        # the kernel's: float(q) * scale, rounded once into x's type
        y_lib = torch.empty_like(x)
        torch.mul(q, s, out=y_lib)
        td_lib = (time_ms(torch, [lambda: torch.mul(q, s, out=y_lib)])
                  if torch.equal(y_lib, wire_dequant(q, s, dtype)) else None)
        bq = bound_ms(nbytes(x, q, s), 3.0 * x.numel(), "fp32")
        bd = bound_ms(nbytes(q, s) + x.numel() * x.element_size(),
                      1.0 * x.numel(), "fp32")
        gaps["wire_quant"] += nq * (tq - bq[0])
        gaps["wire_dequant"] += nd * (td - bd[0])
        print(f"wire_quant   {tag}: bitwise; kernel {tq:.4f} ms "
              f"({tq / floor:.2f}x the floor), plain {tq_plain:.4f} ms, "
              f"bound {bq[0]:.5f} ms ({bq[1]}); {nq} launches a run, "
              f"launches x (kernel - bound) {nq * (tq - bq[0]):.4f} ms")
        lib = (f"{td_lib:.4f} ms (torch.mul(q, s, out=y), bitwise equal)"
               if td_lib is not None else "none (torch.mul(q, s, out=y) is "
               "not bitwise the kernel's)")
        print(f"wire_dequant {tag}: bitwise; kernel {td:.4f} ms "
              f"({td / floor:.2f}x the floor), plain {td_plain:.4f} ms, "
              f"library {lib}, bound {bd[0]:.5f} ms ({bd[1]}); {nd} launches "
              f"a run, launches x (kernel - bound) {nd * (td - bd[0]):.4f} ms")
        timings[(tuple(shape), dtype)] = (tq, tq_plain, bq, td, td_plain, bd,
                                          td_lib)
        del x, q, s, y_lib
    print(f"wire launches a run: wire_quant "
          f"{sum(p[-1][0] for p in payloads)}, wire_dequant "
          f"{sum(p[-1][1] for p in payloads)}; "
          f"launches x (kernel - bound) summed: wire_quant "
          f"{gaps['wire_quant']:.4f} ms, wire_dequant "
          f"{gaps['wire_dequant']:.4f} ms")

    # wire_roundtrip: the value and the gradient through the kernels,
    # bitwise the plain path's, two launches of each kernel a call
    for shape, dtype in (((4, 1, 200064), torch.bfloat16),
                         ((128, 512), torch.float32)):
        x = _payload(torch, shape, dtype, rest)
        ct = _payload(torch, shape, dtype, rest)
        before = ops.launch_counts()
        leaf = x.detach().requires_grad_(True)
        y = wire_roundtrip(leaf)
        y.backward(ct)
        after = ops.launch_counts()
        want_y = ref.wire_dequant_ref(*ref.wire_quant_ref(x), dtype)
        want_g = ref.wire_dequant_ref(*ref.wire_quant_ref(ct), dtype)
        torch.cuda.synchronize()
        if not (torch.equal(y, want_y) and torch.equal(leaf.grad, want_g)):
            fail(f"wire_roundtrip {shape} {dtype}: value or gradient not "
                 f"bitwise the plain path's")
        for name in ("wire_quant", "wire_dequant"):
            if after[name] - before[name] != 2:
                fail(f"wire_roundtrip: {after[name] - before[name]} "
                     f"{name} launches for a forward and a backward, not 2")
        print(f"wire_roundtrip {shape} {str(dtype).replace('torch.', '')}: "
              f"value and gradient bitwise the plain path's, 2 launches of "
              f"each kernel")
    return timings, payloads


def _bf16_ulp(torch, ref32):
    """One bf16 ulp of each fp32 reference value.  Below 1/256 of the
    outputs' rms the ulp is taken at that level: where a sum cancels to
    near zero, two fp32 summation orders differ by more than a bf16 ulp
    of the tiny result, and that is the accumulation's error, not the
    output rounding the check is about."""
    floor = max(2.0 ** -126, ref32.square().mean().sqrt().item() / 256)
    mag = ref32.abs().clamp_min(floor)
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
          f"({b[1]}); {versus(t, t_lib, b)}; W cold in L2")

    # the card tests' other shapes (tests/test_torch_kernels.py, Q8_CARD),
    # Qwen3-30B-A3B's fused entry (q, k and v: 4096 + 512 + 512) and
    # InternVL2-2B's (2048 + 1024 + 1024), from
    # a generator of their own so the checks after this one see the inputs
    # they always have; W cold where its copies exceed the L2
    own = torch.Generator(device="cuda").manual_seed(16)
    for tag, widths, lead, cols, bias, wd, od in (
            ("2 parts (4,1,1000|2072)x(3072,5120)+b, bf16 W, fp32 out",
             (1000, 2072), (4, 1), 5120, True, torch.bfloat16, torch.float32),
            ("15 rows (15,3072)x(3072,5120) bf16", (3072,), (15,), 5120,
             False, torch.bfloat16, torch.bfloat16),
            ("fp32 W that TMA cannot address (4,3,96|33)x(129,5121)+b",
             (96, 33), (4, 3), 5121, True, torch.float32, torch.float32),
            ("35 rows (5,7,64|31)x(95,200)+b, fp32 W, bf16 out", (64, 31),
             (5, 7), 200, True, torch.float32, torch.bfloat16),
            ("Qwen3-MoE decode entry (4,1,2048)x(2048,5120) bf16", (2048,),
             (4, 1), 5120, False, torch.bfloat16, torch.bfloat16),
            ("InternVL2-2B decode entry (4,1,2048)x(2048,4096) bf16",
             (2048,), (4, 1), 4096, False, torch.bfloat16, torch.bfloat16)):
        packs = [wire_quant(_payload(torch, lead + (k,), torch.float32, own))
                 for k in widths]
        qs_, ss_ = [p[0] for p in packs], [p[1] for p in packs]
        w_ = (torch.randn((sum(widths), cols), generator=own, device="cuda")
              / sum(widths) ** 0.5).to(wd)
        b_ = (torch.randn((cols,), generator=own, device="cuda").to(wd)
              if bias else None)
        y_ = splitcat_linear_q8(qs_, ss_, w_, b_, od)
        y32_ = splitcat_linear_q8_plain(qs_, ss_, w_, b_, torch.float32)
        torch.cuda.synchronize()
        if od == torch.float32:
            if not torch.allclose(y_, y32_, rtol=1e-4, atol=1e-4):
                fail(f"splitcat_linear_q8 {tag}: max abs err "
                     f"{(y_ - y32_).abs().max().item():.3e} (1e-4)")
        elif bool(((y_.float() - y32_).abs() > _bf16_ulp(torch, y32_)).any()):
            fail(f"splitcat_linear_q8 {tag}: beyond 1 bf16 ulp")
        copies = [w_] + [w_.clone() for _ in range(
            L2_COPIES - 1 if L2_COPIES * nbytes(w_) > L2_BYTES else 0)]
        t_ = time_ms(torch, [lambda wi=wi: splitcat_linear_q8(
            qs_, ss_, wi, b_, od) for wi in copies])
        t_plain_ = time_ms(torch, [lambda wi=wi: splitcat_linear_q8_plain(
            qs_, ss_, wi, b_, od) for wi in copies])
        rows = y_.numel() // cols
        b_n = bound_ms(nbytes(*qs_, *ss_, w_, y_) + (nbytes(b_) if bias
                                                      else 0),
                       2.0 * rows * sum(widths) * cols,
                       "bf16" if wd == torch.bfloat16 else "fp32")
        held = "1e-4" if od == torch.float32 else "1 bf16 ulp"
        cold = "; W cold in L2" if len(copies) > 1 else ""
        # one part and no bias: torch.matmul of the upcast payload times
        # its row scales computes the same function
        lib_ = ""
        if len(widths) == 1 and not bias:
            t_lib_ = time_ms(torch, [
                lambda wi=wi: torch.matmul(qs_[0].to(wd), wi) * ss_[0]
                for wi in copies])
            lib_ = f", library {t_lib_:.4f} ms"
        print(f"splitcat_linear_q8 {tag}: {held}; kernel {t_:.4f} ms, plain "
              f"{t_plain_:.4f} ms{lib_}, bound {b_n[0]:.4f} ms "
              f"({b_n[1]}){cold}")
        del copies
    return max_err, (t, t_plain, t_lib, b)


def check_splitcat_dense(torch, gen) -> tuple:
    """The dense splitcat entry against its plain version: fp32 at
    rtol = atol = 1e-5 on three shapes, bf16 within 1 bf16 ulp of the
    fp32-accumulated plain result.  Returns (max abs err, timings of the
    vertical evaluation's shape)."""
    from repro_torch.kernels.splitcat_linear import (splitcat_linear,
                                                     splitcat_linear_plain)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).to(dtype)

    cases = [
        ("vertical eval (512,512)|(512,512)x(1024,10)+b",
         [randn(512, 512).relu(), randn(512, 512).relu()],
         randn(1024, 10, scale=1024 ** -0.5), randn(10)),
        ("kernel bench (4,64,256)|(4,64,128)x(384,512)",
         [randn(4, 64, 256), randn(4, 64, 128)],
         randn(384, 512, scale=384 ** -0.5), None),
        ("ragged (3,17,96)|(3,17,33)|(3,17,7)x(136,131)+b",
         [randn(3, 17, 96), randn(3, 17, 33), randn(3, 17, 7)],
         randn(136, 131, scale=136 ** -0.5), randn(131)),
        ("multimodal example eval (64,20)|(64,20)x(40,4)+b",
         [randn(64, 20), randn(64, 20)], randn(40, 4, scale=40 ** -0.5),
         randn(4)),
    ]
    max_err, timings = 0.0, {}
    for tag, parts, w, b in cases:
        y = splitcat_linear(parts, w, b)
        want = splitcat_linear_plain(parts, w, b)
        torch.cuda.synchronize()
        err = (y - want).abs().max().item()
        if not torch.allclose(y, want, rtol=1e-5, atol=1e-5):
            fail(f"splitcat_linear {tag}: max abs err {err:.3e} against "
                 "the plain version (rtol=atol=1e-5)")
        max_err = max(max_err, err)
        cat = lambda: torch.cat(parts, -1)
        lib = ((lambda: torch.addmm(b, cat().reshape(-1, w.shape[0]), w))
               if b is not None else (lambda: cat() @ w))
        t = time_ms(torch, [lambda: splitcat_linear(parts, w, b)])
        t_plain = time_ms(torch, [lambda: splitcat_linear_plain(parts, w, b)])
        t_lib = time_ms(torch, [lib])
        rows, k = y.numel() // w.shape[1], w.shape[0]
        bd = bound_ms(nbytes(*parts, w, y) + (nbytes(b) if b is not None
                                              else 0),
                      2.0 * rows * k * w.shape[1], "fp32")
        print(f"splitcat_linear {tag} fp32: allclose 1e-5, max abs err "
              f"{err:.3e}; kernel {t:.4f} ms, plain {t_plain:.4f} ms, "
              f"library {t_lib:.4f} ms, bound {bd[0]:.5f} ms ({bd[1]}); "
              f"{versus(t, t_lib, bd)}")
        timings[tag] = (t, t_plain, t_lib, bd)

    # bf16 parts and W: one rounding of the fp32 sum
    parts = [randn(512, 512, dtype=torch.bfloat16),
             randn(512, 512, dtype=torch.bfloat16)]
    w = randn(1024, 10, scale=1024 ** -0.5, dtype=torch.bfloat16)
    b = randn(10, dtype=torch.bfloat16)
    y = splitcat_linear(parts, w, b)
    y32 = splitcat_linear_plain([p.float() for p in parts], w.float(),
                                b.float())
    torch.cuda.synchronize()
    beyond = int(((y.float() - y32).abs() > _bf16_ulp(torch, y32)).sum())
    if beyond:
        fail(f"splitcat_linear bf16: {beyond} outputs beyond 1 bf16 ulp of "
             "the fp32-accumulated plain result")
    print("splitcat_linear (512,512)|(512,512)x(1024,10)+b bf16: within 1 "
          "bf16 ulp of the fp32 plain result")
    return max_err, timings[cases[0][0]]


def check_rmsnorm(torch) -> tuple:
    """rmsnorm against its plain version: float32 at rtol 1e-5 (atol
    1e-6), bf16 within 1 bf16 ulp of the float32 plain result on the
    same inputs (the kernel sums in another order and rsqrtf is within 2
    ulp).  Timed at each shape, the kernel, the plain version and
    `F.rms_norm` alike: cold in L2 at the prefill shapes, warm at decode
    (`cold_copies`); then each width's rows 0-3 normalised among 1, 4, 8
    and 512 rows must be bitwise equal.  Returns (max abs
    err against the plain output in the same type, timings at the Mamba2
    prefill's (4,512,768) bf16)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm

    gen = torch.Generator(device="cuda").manual_seed(768)
    # Mamba2, phi4-mini and RecurrentGemma's widths, then the MoE family's:
    # Qwen3-30B-A3B's 2048, DeepSeek-V2's 5120 (Qwen1.5-32B's too), MLA's
    # q_norm (1536) and kv_norm (512), then ChatGLM3-6B's 4096 and
    # Mistral-Large's 12,288, at prefill and at decode; then the 100M
    # example's and quickstart's training rows (d 512 and 128)
    shapes = [(4, 512, 768), (4, 1, 768), (4, 512, 1536), (4, 1, 3072),
              (4, 128, 2048), (4, 1, 2048), (4, 128, 5120), (4, 1, 5120),
              (4, 128, 512), (4, 1, 512), (4, 1, 1536), (4, 128, 4096),
              (4, 1, 4096), (4, 128, 12288), (4, 1, 12288),
              (16, 128, 512), (8, 32, 128)]
    max_err, timings = 0.0, {}
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            sc = (1 + 0.1 * torch.randn(shape[-1:], generator=gen,
                                        device="cuda")).to(dtype)
            y = rmsnorm(x, sc)
            want = ref.rmsnorm_ref(x, sc)
            y32 = ref.rmsnorm_ref(x.float(), sc.float())
            torch.cuda.synchronize()
            err = (y.float() - want.float()).abs().max().item()
            max_err = max(max_err, err)
            tag = f"{shape} {str(dtype).replace('torch.', '')}"
            if dtype == torch.float32:
                if not torch.allclose(y, y32, rtol=1e-5, atol=1e-6):
                    fail(f"rmsnorm {tag}: max abs err {err:.3e} against the "
                         "plain version (rtol 1e-5, atol 1e-6)")
            else:
                beyond = int(((y.float() - y32).abs()
                              > _bf16_ulp(torch, y32)).sum())
                if beyond:
                    fail(f"rmsnorm {tag}: {beyond} outputs beyond 1 bf16 ulp "
                         "of the float32 plain result")
            # a prefill's x and scale cold: copies cycled past the L2,
            # every output kept; a decode row's warm (cold_copies)
            k = cold_copies(nbytes(x, sc, y))
            ins = [(x, sc)] + [(x.clone(), sc.clone()) for _ in range(k - 1)]

            def timed(f):
                return time_ms(torch, [lambda a=a, b=b: f(a, b)
                                       for a, b in ins],
                               calls=max(24, k), keep=k > 0)
            t = timed(rmsnorm)
            t_plain = timed(ref.rmsnorm_ref)
            t_lib = (timed(lambda a, b: F.rms_norm(
                a.float(), shape[-1:], b.float(), 1e-6).to(dtype))
                if hasattr(F, "rms_norm") else None)
            del ins
            bd = bound_ms(nbytes(x, sc, y), 4.0 * x.numel(), "fp32")
            lib = f"{t_lib:.4f} ms" if t_lib is not None else "none"
            held = "rtol 1e-5" if dtype == torch.float32 else "1 bf16 ulp"
            l2 = (f"cold in L2 ({k} copies)" if k
                  else "warm in L2, no roofline claim")
            print(f"rmsnorm {tag}: {held}, max abs err {err:.3e}; kernel "
                  f"{t:.4f} ms, plain "
                  f"{t_plain:.4f} ms, library {lib}, bound {bd[0]:.4g} ms "
                  f"({bd[1]}); {l2}")
            timings[(shape, dtype)] = (t, t_plain, t_lib, bd)
    # a row's output does not depend on the rows around it (the Batcher's
    # solo and stacked steps, monolithic == split): rows 0-3 normalised
    # among 1, 4, 8 and 512 rows are bitwise equal, at every width
    widths = sorted({shape[-1] for shape in shapes})
    for d in widths:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((512, d), generator=gen, device="cuda").to(dtype)
            sc = (1 + 0.1 * torch.randn((d,), generator=gen,
                                        device="cuda")).to(dtype)
            full = rmsnorm(x, sc)
            for n in (1, 4, 8):
                if not torch.equal(rmsnorm(x[:n].clone(), sc)[:4],
                                   full[:min(n, 4)]):
                    fail(f"rmsnorm width {d} {dtype}: rows 0-3 among {n} "
                         "rows differ from the same rows among 512")
    print(f"rmsnorm rows 0-3 among 1, 4, 8 and 512 rows: bitwise equal at "
          f"widths {widths}, bf16 and fp32")
    return max_err, timings[((4, 512, 768), torch.bfloat16)]


# the bound's tile: the TPU kernel's own default chunk (ssd_scan.py:66),
# whatever tile the CUDA kernel uses, so the yardstick prices the same work
# across PRs
SSD_TILE = 64


def ssd_bound(b, s, h, g, p, n, bc_type, in_bytes, out_bytes) -> tuple:
    """The SSD's least time at the kernel's 64-row tile, against each
    input read and each output written once.  Operations: per (batch,
    head, tile) the masked product of C B^T with xd (P wide, lower
    triangle), the carried state's product with C and the state update,
    in float32 (dt is float32, so are xd and the state); per (batch,
    group, tile) the lower triangle of C B^T (N deep), shared by the
    group's heads, at the rate of B and C's type (`bc_type`: a bf16
    product accumulated in float32 on the tensor cores loses nothing)."""
    head_ops = group_ops = 0.0
    for t0 in range(0, s, SSD_TILE):
        q = min(SSD_TILE, s - t0)
        tri = q * (q + 1) / 2
        head_ops += 2 * tri * p + 4 * q * p * n
        group_ops += 2 * tri * n
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = (b * h * head_ops / PEAK_OPS_PER_S["fp32"]
             + b * g * group_ops / PEAK_OPS_PER_S[bc_type]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_ssd(torch) -> tuple:
    """The SSD scan against its plain version (the reference's chunked
    form) at the Mamba2 prefill's full-width shape, from a zero and from a
    carried state, and at a ragged length.  Tolerance: y and the state
    within 1e-3 x their rms + 1e-4 x |value| of the float32 plain result
    (the two tile the sequence differently, 64 rows against the model's
    chunk of 256, so their decays round differently; the plain form at
    the two tiles, and a float64 evaluation, agree within it on the CPU:
    tests/test_torch_kernels.py::test_ssd_chunk_length_changes_only_rounding),
    plus one bf16 ulp for a bf16 y.
    Returns (max abs err, timings at the zero-state prefill shape)."""
    from repro_torch.kernels.ssd_scan import ssd_chunked_plain, ssd_scan

    gen = torch.Generator(device="cuda").manual_seed(512)
    b, s, h, g, p, n = 4, 512, 24, 1, 64, 128
    x = (0.5 * torch.randn((b, s, h, p), generator=gen, device="cuda")
         ).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen,
                                                  device="cuda"))
    A = -torch.linspace(1.0, 16.0, h, device="cuda")   # the model's init
    Bm, Cm = ((0.3 * torch.randn((b, s, g, n), generator=gen, device="cuda")
               ).to(torch.bfloat16) for _ in range(2))
    init = torch.randn((b, h, p, n), generator=gen, device="cuda")

    def within(got, want, what, ulp=False):
        rms = want.square().mean().sqrt().item()
        tol = 1e-3 * rms + 1e-4 * want.abs()
        if ulp:
            tol = tol + _bf16_ulp(torch, want)
        err = (got.float() - want).abs()
        if bool((err > tol).any()):
            fail(f"ssd_scan {what}: {int((err > tol).sum())} values beyond "
                 f"1e-3 rms + 1e-4 |v|{' + 1 bf16 ulp' if ulp else ''} of "
                 f"the float32 plain result (max abs err "
                 f"{err.max().item():.3e}, rms {rms:.3f})")
        return err.max().item()

    max_err, timed = 0.0, None
    for tag, length, chunk, state in (
            ("prefill (4,512,24,64) bf16, zero state", 512, 256, None),
            ("prefill (4,512,24,64) bf16, carried state", 512, 256, init),
            ("ragged (4,300,24,64) bf16, carried state", 300, 300, init)):
        args = [t[:, :length] if t.ndim > 1 else t for t in (x, dt, A, Bm,
                                                            Cm)]
        y, st = ssd_scan(*args, chunk=chunk, initial_state=state,
                         return_state=True)
        y_p, st_p = ssd_chunked_plain(*[a.float() for a in args], chunk=chunk,
                                      initial_state=state, return_state=True)
        torch.cuda.synchronize()
        e_y = within(y, y_p, tag + " y", ulp=True)
        e_s = within(st, st_p, tag + " state")
        # against the plain version in the inputs' own types
        y_same = ssd_chunked_plain(*args, chunk=chunk, initial_state=state)
        e_same = (y.float() - y_same.float()).abs().max().item()
        max_err = max(max_err, e_same)
        t = time_ms(torch, [lambda: ssd_scan(*args, chunk=chunk,
                                             initial_state=state)],
                    calls=8, reps=9)
        t_plain = time_ms(torch, [lambda: ssd_chunked_plain(
            *args, chunk=chunk, initial_state=state)], calls=4, reps=5)
        bd = ssd_bound(b, length, h, g, p, n, "bf16",
                       nbytes(*args) + (nbytes(state) if state is not None
                                        else 0), nbytes(y))
        print(f"ssd_scan {tag}: y max abs err {e_y:.3e} against the float32 "
              f"plain result, {e_same:.3e} against the bf16 plain output; "
              f"state {e_s:.3e}; kernel {t:.4f} ms, plain {t_plain:.4f} ms, "
              f"library none, bound {bd[0]:.4f} ms ({bd[1]})")
        if timed is None:
            timed = (t, t_plain, None, bd)
    return max_err, timed


def flash_bound(b, s, h, d, causal, window, in_bytes, out_bytes, dv=None,
                pv_products: int = 2) -> tuple:
    """Flash attention's least time: only the (query, key) pairs the mask
    leaves, 2 d operations each for q . k and 2 dv (d unless given) each
    for each of `pv_products` p v products, all at the bf16 tensor-core
    rate; against each input read and the output written once.  q . k on
    bf16 inputs accumulated in float32 loses nothing.  P is float32 in
    the reference, and one bf16 product would round it to 8 bits; P_hi +
    P_lo (two bf16 products into one float32 accumulator) carries it to
    about 2^-17, below a bf16 ulp of an output of typical size.  The
    kernel runs a third piece of P to hold the 1-ulp check on outputs
    near zero too, so it does more work than this bound prices."""
    dv = d if dv is None else dv
    pairs = 0
    for i in range(s):
        hi = i + 1 if causal else s
        lo = max(0, i - window + 1) if window else 0
        pairs += hi - lo
    ops = 2.0 * (d + pv_products * dv) * pairs * b * h
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S["bf16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the flash case that runs the kernel's non-causal mode (Whisper's encoder)
WHISPER_ENC = "Whisper-base encoder (non-causal)"


def check_flash(torch) -> tuple:
    """Flash attention against its plain version (the grouped einsum with
    the causal / window mask, softmax in float32) at the prefill shapes
    of the served models, phi4-mini's causal GQA, RecurrentGemma-2B's
    2048-row local attention over a 4096-row prompt, DeepSeek-V2's MLA
    (128 heads, q/k 192 wide, v 128, scale 1/sqrt(192)), Qwen3-30B-A3B's
    GQA (32 heads over 4, a group of 8), ChatGLM3-6B's (32 over 2, a group
    of 16), the reference's qwen1_5_32b plain MHA (40 over 40; the
    published Qwen1.5-32B is 40 over 8) and Mistral-Large's (96
    over 8, a group of 12), InternVL2-2B's (16 over 8 at its 384-row
    prefill: 256 patches and a 128-token prompt), Whisper-base's decoder
    prefill (MHA 8 of 64 over 64 rows) and, non-causal, Whisper-base's
    encoder (MHA 8 of 64 over its 1,500 frames, which leave 28 of the last
    64-row KV tile real: only the bound check masks them), plus a
    ragged fp32 case at head_dim 32 with a window.  Tolerance: bf16
    within 1 bf16 ulp (floored at 1/256 of the rms) of the float32 plain
    result on the same inputs; fp32 within rtol = atol = 2e-5 (the sums
    run in another order).  Returns (max abs err against the plain
    output in the same type, {tag: timings})."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(4096)
    cases = [("phi4-mini prefill", (4, 128, 24, 8, 128, 128), None, True),
             ("RecurrentGemma-2B prefill", (4, 4096, 10, 1, 256, 256), 2048,
              True),
             ("ragged", (2, 300, 4, 2, 32, 32), 100, False),
             ("DeepSeek-V2 MLA prefill", (4, 128, 128, 128, 192, 128), None,
              True),
             ("Qwen3-MoE prefill", (4, 128, 32, 4, 128, 128), None, True),
             ("ChatGLM3-6B prefill", (4, 128, 32, 2, 128, 128), None, True),
             ("qwen1_5_32b MHA 40/40 prefill", (4, 128, 40, 40, 128, 128),
              None, True),
             ("Mistral-Large prefill", (4, 128, 96, 8, 128, 128), None,
              True),
             ("100M example training", (16, 128, 8, 4, 64, 64), None, True),
             ("quickstart training", (8, 32, 4, 2, 32, 32), None, True),
             ("InternVL2-2B prefill", (4, 384, 16, 8, 128, 128), None, True),
             ("Whisper-base decoder prefill", (4, 64, 8, 8, 64, 64), None,
              True),
             (WHISPER_ENC, (4, 1500, 8, 8, 64, 64), None, True)]
    max_err, timings = 0.0, {}
    for tag, (b, s, h, kh, d, dv), window, timed in cases:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, dv)))
        causal = tag != WHISPER_ENC
        kw = dict(causal=causal, window=window)
        want32 = ref.flash_attention_ref(q, k, v, **kw)
        y32 = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        err32 = (y32 - want32).abs().max().item()
        if not torch.allclose(y32, want32, rtol=2e-5, atol=2e-5):
            fail(f"flash_attention {tag} fp32: max abs err {err32:.3e} "
                 "against the plain version (rtol = atol = 2e-5)")
        del want32, y32
        qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
        del q, k, v
        y = flash_attention(qb, kb, vb, **kw)
        y_plain = ref.flash_attention_ref(qb, kb, vb, **kw)
        y_ref32 = ref.flash_attention_ref(qb.float(), kb.float(),
                                          vb.float(), **kw)
        torch.cuda.synchronize()
        beyond = int(((y.float() - y_ref32).abs()
                      > _bf16_ulp(torch, y_ref32)).sum())
        if beyond:
            fail(f"flash_attention {tag} bf16: {beyond} outputs beyond 1 "
                 "bf16 ulp of the float32 plain result")
        err = (y.float() - y_plain.float()).abs().max().item()
        max_err = max(max_err, err)
        del y_plain, y_ref32
        shape = (f"q {(b, s, h, d)} k {(b, s, kh, d)} v {(b, s, kh, dv)} "
                 f"window {window}" + ("" if causal else ", non-causal"))
        print(f"flash_attention {tag} {shape}: fp32 max abs err {err32:.3e} "
              f"(2e-5), bf16 within 1 ulp, max abs err {err:.3e} against the "
              "bf16 plain output")
        if not timed:
            continue
        big = s * s * b * h > 1e8
        t = time_ms(torch, [lambda: flash_attention(qb, kb, vb, **kw)],
                    **(dict(calls=4, reps=5) if big else {}))
        t_plain = time_ms(torch, [lambda: ref.flash_attention_ref(
            qb, kb, vb, **kw)], **(dict(calls=1, reps=3) if big else {}))
        qt, kt, vt = (x.transpose(1, 2) for x in (qb, kb, vb))
        mask = ref.causal_mask(s, s, window=window, device="cuda")

        def library():
            if window is None:
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=causal,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        try:
            t_lib = time_ms(torch, [library], **(dict(calls=4, reps=5)
                                                 if big else {}))
        except (RuntimeError, TypeError) as e:
            print(f"  library yardstick not timed: {e}")
            t_lib = None
        bd = flash_bound(b, s, h, d, causal, window, nbytes(qb, kb, vb),
                         nbytes(y), dv)
        one = flash_bound(b, s, h, d, causal, window, nbytes(qb, kb, vb),
                          nbytes(y), dv, pv_products=1)
        lib = f"{t_lib:.4f} ms" if t_lib is not None else "none"
        print(f"  kernel {t:.4f} ms, plain {t_plain:.4f} ms, library "
              f"(scaled_dot_product_attention) {lib}, bound {bd[0]:.4f} ms "
              f"({bd[1]}; with one p v product {one[0]:.4f} ms, {one[1]}); "
              f"{versus(t, t_lib, bd)}")
        timings[tag] = (t, t_plain, t_lib, bd, err)
        del qb, kb, vb, y, qt, kt, vt, mask
        torch.cuda.empty_cache()
    return max_err, timings


# phase 3u's long-context prefill: phi4-mini's GQA over 12,288 rows within
# its 8,192-row long window, held in query blocks (the plain version's
# whole (24, 12288, 12288) float32 score tensor would take 14.5 GB)
FLASH_LONG = "phi4-mini long-context prefill (window 8192)"
FLASH_LONG_SHAPE, FLASH_LONG_WINDOW, FLASH_LONG_BLOCK = \
    (1, 12288, 24, 8, 128, 128), 8192, 2048


def _flash_blocks(torch, q, k, v, window: int, block: int):
    """The plain causal-window attention (`kernels.ref.grouped_attention`,
    softmax in float32) one block of `block` query rows at a time, each
    over the keys its window reaches."""
    from repro_torch.kernels import ref

    S = q.shape[1]
    out = torch.empty_like(q)
    for i0 in range(0, S, block):
        i1 = min(S, i0 + block)
        k0 = max(0, i0 - window + 1)
        qp = torch.arange(i0, i1, device=q.device)[:, None]
        kp = torch.arange(k0, i1, device=q.device)[None, :]
        mask = (kp <= qp) & (kp > qp - window)
        out[:, i0:i1] = ref.grouped_attention(
            q[:, i0:i1], k[:, k0:i1], v[:, k0:i1], mask,
            scale=1.0 / math.sqrt(q.shape[-1]))
    return out


def check_flash_long(torch) -> tuple:
    """Flash attention at phase 3u's long-context prefill, fp32 within
    rtol = atol = 2e-5 of the plain version and bf16 within the card
    tests' float64 bound (one bf16 ulp plus a float32 sum's worst case
    over the row's keys; the other cases' one ulp of the float32 plain
    result does not hold over 8,192-key rows, PERF.md), both evaluated in
    query blocks; timed beside the blocked plain version,
    `scaled_dot_product_attention` with the window mask and the bound
    over the unmasked pairs.  Returns (t, t_plain, t_lib, bound, err)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    b, s, h, kh, d, dv = FLASH_LONG_SHAPE
    W, blk = FLASH_LONG_WINDOW, FLASH_LONG_BLOCK
    gen = torch.Generator(device="cuda").manual_seed(12288)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for shape in ((b, s, h, d), (b, s, kh, d), (b, s, kh, dv)))
    kw = dict(causal=True, window=W)
    want32 = _flash_blocks(torch, q, k, v, W, blk)
    y32 = flash_attention(q, k, v, **kw)
    err32 = (y32 - want32).abs().max().item()
    if not torch.allclose(y32, want32, rtol=2e-5, atol=2e-5):
        fail(f"flash_attention {FLASH_LONG} fp32: max abs err {err32:.3e}")
    del want32, y32
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    del q, k, v
    y = flash_attention(qb, kb, vb, **kw)
    y_ref32 = _flash_blocks(torch, qb.float(), kb.float(), vb.float(), W,
                            blk)
    ulp1 = int(((y.float() - y_ref32).abs()
                > _bf16_ulp(torch, y_ref32)).sum())
    del y_ref32
    # the float64 bound of the card tests (tests/test_torch_kernels.py,
    # `_flash_f64_bound`): one bf16 ulp of the float64 result plus
    # n_keys 2^-24 sum|p||v|/l, a float32 sum's worst case over the row's
    # keys, which reach 8,192 here
    q64, k64, v64 = (t.double() for t in (qb, kb, vb))
    want64 = _flash_blocks(torch, q64, k64, v64, W, blk // 2)
    cond = _flash_blocks(torch, q64, k64, v64.abs(), W, blk // 2)
    del q64, k64, v64
    n_keys = (torch.arange(s, device="cuda", dtype=torch.float64)
              + 1).clamp_max(W)
    ulp = torch.exp2(torch.floor(torch.log2(
        want64.abs().clamp_min(2.0 ** -126))) - 7)
    bound = ulp + n_keys[None, :, None, None] * 2.0 ** -24 * cond
    beyond = int(((y.double() - want64).abs() > bound).sum())
    del want64, cond, ulp, bound
    if beyond:
        fail(f"flash_attention {FLASH_LONG} bf16: {beyond} outputs beyond "
             "the float64 bound")
    y_plain = _flash_blocks(torch, qb, kb, vb, W, blk)
    err = (y.float() - y_plain.float()).abs().max().item()
    del y_plain
    t = time_ms(torch, [lambda: flash_attention(qb, kb, vb, **kw)], calls=4,
                reps=5)
    t_plain = time_ms(torch, [lambda: _flash_blocks(torch, qb, kb, vb, W,
                                                    blk)], calls=1, reps=3)
    qt, kt, vt = (x.transpose(1, 2) for x in (qb, kb, vb))
    mask = ref.causal_mask(s, s, window=W, device="cuda")
    t_lib = time_ms(torch, [lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True)], calls=4, reps=5)
    bd = flash_bound(b, s, h, d, True, W, nbytes(qb, kb, vb), nbytes(y), dv)
    print(f"flash_attention {FLASH_LONG} q {(b, s, h, d)} k {(b, s, kh, d)} "
          f"v {(b, s, kh, dv)}: fp32 max abs err {err32:.3e} (2e-5), bf16 "
          f"within the float64 bound ({ulp1} of {y.numel():,} outputs "
          f"beyond 1 bf16 ulp of the float32 plain result), max abs err "
          f"{err:.3e} against the bf16 plain output; kernel {t:.4f} ms, plain (in {blk}-row query blocks) "
          f"{t_plain:.4f} ms, library (scaled_dot_product_attention, window "
          f"mask) {t_lib:.4f} ms, bound {bd[0]:.4f} ms ({bd[1]}, unmasked "
          f"pairs only); {versus(t, t_lib, bd)}; {card_line()}")
    del qb, kb, vb, y, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return t, t_plain, t_lib, bd, err


def time_events_ms(torch, fn, reps: int = 10) -> float:
    """Median device time of one call of `fn` from CUDA events around it,
    after a warm-up call: for work a CUDA graph cannot capture (an
    autograd backward)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_grads(torch) -> dict:
    """Rows 5-7's gradient on the card at the LM training shapes: fp32 at
    phase 3j's shapes, and bf16 at phase 3k's (the CLI's batch 8 x seq 512:
    rmsnorm (8,512,768) and (8,512,2560), RecurrentGemma's flash q
    (8,512,10,256), k/v (8,512,1,256) with its 2048-row window, Mamba2's
    SSD x (8,512,24,64) at chunk 256, and at the CLI's default seq 64,
    chunk 64; and phase 3r's Whisper encoder attention, non-causal, q/k/v
    (8,1500,8,64)).  Every input requires grad, so each wrapper goes through
    its autograd Function; its forward must launch the kernel once (held
    to the plain forward as above in fp32: rmsnorm at 1e-5, flash at
    2e-5, the SSD within 1e-3 x rms + 1e-4 x |v|; in bf16 within 2 bf16
    ulps of the plain bf16 output, plus the SSD's fp32 term), its output
    carry a grad_fn, and its backward give the plain version's autograd
    gradients within rtol 1e-5, atol 1e-6 x the largest in fp32, and
    within rtol = 2**-7, atol = 2**-7 x the largest (one bf16 ulp at the
    top of a binade) in bf16.  Flash's and the SSD's backward recompute
    the plain version on the saved inputs and launch nothing (the same
    arithmetic; only a library's choice of summation order could part
    them); rmsnorm's launches exactly its RMS_BWD_KERNELS backward kernels
    (the closed form, summed in another order), and two of its backward
    calls give the same bits.  The SSD's x, B and C are views into one
    projection, as Mamba2 hands them over.  Timed: the kernel's forward
    at the shape (fp32: flash runs its `flash_fwd` kernel, not the bf16
    `wgmma` one) beside the plain forward, the Function's backward, the
    plain version's backward alone, and where a PyTorch call computes the
    same function (`F.rms_norm`, `scaled_dot_product_attention`) that
    call's forward and backward; rmsnorm's backward kernels alone too
    (CUDA-graph replays, inputs cold in L2) beside their bound (x, g and
    scale read, dx and dscale written) and the bytes of their fp32
    workspace of partial dscale rows (written once and read once, on top
    of the bound).  Returns {kernel: (backward ms, plain backward ms,
    library backward ms, backward kernels ms, their bound, workspace
    bytes)} at each kernel's first fp32 shape (the last three None but for
    rmsnorm), and the same at its first bf16 shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rmsnorm import _launch_bwd, bwd_grid
    from repro_torch.kernels.ssd_scan import ssd_chunked_plain

    gen = torch.Generator(device="cuda").manual_seed(2048)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    bf = torch.bfloat16

    def close(tol, dtype=torch.float32):
        def ok(a, b):
            if dtype == torch.float32:
                return torch.allclose(a, b, rtol=tol, atol=tol)
            return bool(((a.float() - b.float()).abs()
                         <= 2 * _bf16_ulp(torch, b.float())).all())
        return ok

    def ssd_close(dtype):
        def ok(a, b):
            """The kernel tiles 64 rows, the plain form the model's chunk
            of 256: their decays round differently (check_ssd's rule)."""
            a, b = a.float(), b.float()
            tol = 1e-3 * b.square().mean().sqrt() + 1e-4 * b.abs()
            if dtype != torch.float32:
                tol = tol + 2 * _bf16_ulp(torch, b)
            return bool(((a - b).abs() <= tol).all())
        return ok

    def name(dtype):
        return str(dtype).replace("torch.", "")

    def rms(d, b=LB, s=LS, dtype=torch.float32):
        def make():
            return [randn(b, s, d).to(dtype),
                    (1 + 0.1 * randn(d)).to(dtype)], {}

        def lib(x, sc):
            return F.rms_norm(x.float(), (d,), sc.float(), 1e-6).to(x.dtype)
        return (f"rmsnorm ({b},{s},{d}) {name(dtype)}", "rmsnorm", make,
                ops.rmsnorm, ref.rmsnorm_ref, lib, close(1e-5, dtype),
                dtype)

    def flash(window, b=LB, s=LS, h=24, kv=8, d=128, dtype=torch.float32,
              causal=True):
        def make():
            return ([randn(b, s, h, d).to(dtype), randn(b, s, kv, d).to(dtype),
                     randn(b, s, kv, d).to(dtype)],
                    {"window": window, "causal": causal})

        def lib(q, k, v, window, causal):
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if window is None:
                o = F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal,
                                                   enable_gqa=True)
            else:
                mask = ref.causal_mask(s, s, window=window, device=q.device)
                o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                   enable_gqa=True)
            return o.transpose(1, 2)
        return (f"flash_attention q ({b},{s},{h},{d}) k/v ({b},{s},{kv},{d}) "
                f"{name(dtype)} {'causal' if causal else 'non-causal'}, "
                f"window {window}", "flash_attention",
                make, ops.flash_attention, ref.flash_attention_ref, lib,
                close(2e-5, dtype), dtype)

    def ssd(carried, b=LB, s=LS, chunk=256, dtype=torch.float32):
        def make():
            h, p, n = 24, 64, 128
            # x at 0.5 and B/C at 0.3, as check_ssd draws them; dt, A and
            # a carried state float32, as Mamba2 hands them over
            proj = torch.cat([0.5 * randn(b, s, h * p),
                              0.3 * randn(b, s, 2 * n)], dim=-1).to(dtype)
            dt = F.softplus(randn(b, s, h))
            A = -torch.linspace(1.0, 16.0, h, device="cuda")
            init = randn(b, h, p, n) if carried else None
            return ([proj, dt, A] + ([init] if carried else []),
                    {"chunk": chunk, "return_state": True})
        return (f"ssd_scan x ({b},{s},24,64) B/C ({b},{s},1,128) "
                f"{name(dtype)} chunk {chunk}, "
                f"{'carried' if carried else 'zero'} state", "ssd_scan",
                make, ops.ssd_scan, ssd_chunked_plain, None,
                ssd_close(dtype), dtype)

    def ssd_args(ins):
        """(proj, dt, A[, init]) -> the scan's arguments, x/B/C as views."""
        proj, dt, A = ins[:3]
        x = proj[..., :24 * 64].unflatten(-1, (24, 64))
        Bm = proj[..., 24 * 64:24 * 64 + 128].unflatten(-1, (1, 128))
        Cm = proj[..., 24 * 64 + 128:].unflatten(-1, (1, 128))
        return (x, dt, A, Bm, Cm), (ins[3] if len(ins) > 3 else None)

    out, out_bf16 = {}, {}
    for tag, name, make, fn, plain, lib, fwd_close, dtype in (
            rms(768), rms(3072), flash(None), flash(128), ssd(False),
            ssd(True), rms(512, 16, 128), rms(128, 8, 32),
            flash(None, 16, 128, 8, 4, 64), flash(None, 8, 32, 4, 2, 32),
            rms(768, CLI_B, CLI_S, bf), rms(2560, CLI_B, CLI_S, bf),
            flash(2048, CLI_B, CLI_S, 10, 1, 256, bf),
            ssd(False, CLI_B, CLI_S, 256, bf), ssd(False, CLI_B, 64, 64, bf),
            flash(None, CLI_B, 1500, 8, 8, 64, bf, causal=False)):
        ins, kw = make()
        g_tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        a_tol = 1e-6 if dtype == torch.float32 else 2.0 ** -7

        def call(f, leaves):
            if name != "ssd_scan":
                return f(*leaves, **kw)
            args, init = ssd_args(leaves)
            return f(*args, initial_state=init, **kw)
        runs = []
        for f in (fn, plain):
            leaves = [t.detach().clone().requires_grad_() for t in ins]
            before = ops.launch_counts()
            o = call(f, leaves)
            o = list(o) if isinstance(o, tuple) else [o]
            runs.append((leaves, o, before, ops.launch_counts()))
        (leaves, o, before, after), (p_leaves, p_o, _, _) = runs
        if after[name] - before[name] != 1 or any(
                after[k] != before[k] for k in after if k != name):
            fail(f"{tag}: a grad-requiring input launched "
                 f"{ {k: after[k] - before[k] for k in after} }, not one "
                 f"{name}")
        if any(t.grad_fn is None for t in o):
            fail(f"{tag}: the kernel's output has no grad_fn")
        for a, b in zip(o, p_o):
            if not fwd_close(a, b):
                fail(f"{tag}: forward max abs err "
                     f"{(a - b).abs().max().item():.3e} against the plain "
                     "version")
        cts = [randn(*t.shape).to(t.dtype) for t in o]
        g = torch.autograd.grad(o, leaves, cts, retain_graph=True)
        g_p = torch.autograd.grad(p_o, p_leaves, cts, retain_graph=True)
        n_bwd = RMS_BWD_KERNELS if name == "rmsnorm" else 0
        moved = {k: v - after[k] for k, v in ops.launch_counts().items()}
        if moved != {k: n_bwd * (k == "rmsnorm_bwd") for k in moved}:
            fail(f"{tag}: the backward launched {moved}, not "
                 f"{n_bwd} rmsnorm_bwd and nothing else")
        if name == "rmsnorm":
            again = torch.autograd.grad(o, leaves, cts, retain_graph=True)
            if not all(torch.equal(a, b) for a, b in zip(g, again)):
                fail(f"{tag}: two backward calls differ")
        worst = 0.0
        for a, b in zip(g, g_p):
            a, b = a.float(), b.float()
            scale = b.abs().max().item()
            worst = max(worst, (a - b).abs().max().item() / max(scale,
                                                                1e-30))
            if not torch.allclose(a, b, rtol=g_tol, atol=a_tol * scale):
                fail(f"{tag}: gradient max abs err "
                     f"{(a - b).abs().max().item():.3e} against the plain "
                     f"version's autograd (rtol {g_tol:.3g}, atol "
                     f"{a_tol:.3g} x {scale:.3e})")
        fixed = [t.detach() for t in ins]
        t_fwd = time_ms(torch, [lambda: call(fn, fixed)], calls=8, reps=9)
        t_fwd_plain = time_ms(torch, [lambda: call(plain, fixed)], calls=4,
                              reps=5)
        t_bwd = time_events_ms(torch, lambda: torch.autograd.grad(
            o, leaves, cts, retain_graph=True))
        t_plain = time_events_ms(torch, lambda: torch.autograd.grad(
            p_o, p_leaves, cts, retain_graph=True))
        t_lib = t_lib_fwd = None
        if lib is not None:
            try:
                t_lib_fwd = time_ms(torch, [lambda: lib(*fixed, **kw)],
                                    calls=8, reps=9)
                l_leaves = [t.detach().clone().requires_grad_() for t in ins]
                l_o = lib(*l_leaves, **kw)
                t_lib = time_events_ms(torch, lambda: torch.autograd.grad(
                    l_o, l_leaves, cts[0], retain_graph=True))
                del l_o, l_leaves
            except (AttributeError, RuntimeError, TypeError) as e:
                print(f"  library yardstick not timed: {e}")
        lib_s = (f"{t_lib_fwd:.4f} / {t_lib:.4f} ms" if t_lib is not None
                 else "none")
        t_k = bd = ws = None
        kern_s = "(plain recompute + autograd)"
        if name == "rmsnorm":
            # the function's own bytes: x, g and scale read, dx and
            # dscale written; the fp32 workspace of partial dscale rows
            # (written once, read once) is the design's overhead, printed
            # beside it.  x, g and scale cold: copies cycled past the L2.
            x, sc = fixed
            n_bytes = nbytes(x, cts[0], sc, g[0], g[1])
            bd = bound_ms(n_bytes, 10.0 * x.numel(), "fp32")
            ws = bwd_grid(x, sc, True) * x.shape[-1] * 4
            k = cold_copies(n_bytes)
            ins = [(x, sc, cts[0])] + [
                (x.clone(), sc.clone(), cts[0].clone())
                for _ in range(k - 1)]
            t_k = time_ms(torch, [
                lambda a=a, b=b, c=c: _launch_bwd(a, b, c, 1e-6)
                for a, b, c in ins], calls=max(8, k), reps=9, keep=True)
            del ins
            kern_s = (f"({RMS_BWD_KERNELS} kernels, bitwise on a second "
                      f"call; alone {t_k:.4f} ms, cold in L2 ({k} copies), "
                      f"bound {bd[0]:.5f} ms ({bd[1]}, {n_bytes} B), "
                      f"{bd[0] / t_k:.1%} of it; workspace {ws} B written "
                      "and read on top)")
        print(f"{tag}, inputs requiring grad: kernel forward (1 "
              f"launch, grad_fn), gradient within rtol {g_tol:.3g} of the "
              f"plain autograd (largest {worst:.2e} of the leaf's scale); "
              f"forward: kernel {t_fwd:.4f} ms, plain {t_fwd_plain:.4f} ms; "
              f"backward {kern_s} {t_bwd:.4f} ms, "
              f"plain backward alone {t_plain:.4f} ms; library forward / "
              f"backward {lib_s}")
        (out if dtype == torch.float32 else out_bf16).setdefault(
            name, (t_bwd, t_plain, t_lib, t_k, bd, ws))
        del runs, leaves, o, p_leaves, p_o, g, g_p, cts
        torch.cuda.empty_cache()
    return out, out_bf16


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
    # rmsnorm: 2 per layer and the final norm at prefill; at decode the
    # fused entry folds the server's first norm into the payload's scales;
    # flash_attention: one per layer at prefill, none at decode (the ring
    # takes the plain grouped attention)
    want = {"wire_quant": 2 + 2 * (GEN - 1), "wire_dequant": 2 + 2 * (GEN - 1),
            "splitcat_linear_q8": GEN - 1, "splitcat_linear": 0,
            "rmsnorm": (2 * cfg.n_layers + 1) + (GEN - 1) * 2 * cfg.n_layers,
            "rmsnorm_bwd": 0, "ssd_scan": 0, "flash_attention": cfg.n_layers}
    hold_launches(launches, want)

    tok = rest[:, -1:]

    def step():
        nonlocal tok
        tok = fused.decode_step(tok)
    profile_device(torch, "decode step", step, t_decode / (GEN - 1))
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


def hold_launches(launches: dict, want: dict):
    """Every kernel's launches on a path equal what the code implies."""
    for name, n in want.items():
        if launches[name] != n:
            fail(f"kernel {name}: {launches[name]} launches on the path, "
                 f"expected {n}")
    if set(launches) != set(want):
        fail(f"launch counters {sorted(launches)} != {sorted(want)}")


def profile_device(torch, label: str, fn, step_s: float, steps: int = 4,
                   span_ms: dict | None = None):
    """Where one step's time goes: device kernel time by kernel from
    torch.profiler over `steps` more calls of `fn`, against the
    unprofiled wall time per step `step_s`.  `span_ms`, when given, maps
    profiler range labels (`torch.profiler.record_function`) to the
    device ms per step of the kernels launched inside each range, which
    this fills in.  It reads the profiler's raw events: building its
    event tree (`prof.events()`) takes seconds a profiled round."""
    import bisect

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    spans = {} if span_ms is None else span_ms
    by_name: dict = {}
    n_kernels = 0
    ranges: dict = {}              # thread -> sorted (start, end, label)
    ops, kernels = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or e.name() in spans:
                continue           # a range on the device's timeline
            us = e.duration_ns() / 1e3
            by_name[e.name()] = by_name.get(e.name(), 0.0) + us
            n_kernels += 1
            kernels.append((e.linked_correlation_id(), us))
        elif spans and e.device_type() == DeviceType.CPU:
            if e.name() in spans and e.is_user_annotation():
                ranges.setdefault(e.start_thread_id(), []).append(
                    (e.start_ns(), e.end_ns(), e.name()))
            ops.append((e.start_thread_id(), e.start_ns(), e.correlation_id()))
    # a kernel belongs to the range that holds the op which launched it:
    # the op's correlation id is the kernel's linked one
    owner = {}
    for r in ranges.values():
        r.sort()
    starts = {t: [a for a, _, _ in r] for t, r in ranges.items()}
    for thread, t0, corr in ops:
        i = bisect.bisect_right(starts.get(thread, []), t0) - 1
        if i >= 0 and t0 <= ranges[thread][i][1]:
            owner[corr] = ranges[thread][i][2]
    for corr, us in kernels:
        if corr in owner:
            spans[owner[corr]] += us / 1e3 / steps
    busy_ms = sum(by_name.values()) / 1e3 / steps
    if busy_ms == 0.0:
        print(f"{label} device time: not measured (the profiler recorded "
              "no device activity)")
        return None
    print(f"{label}: wall {step_s * 1e3:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / (step_s * 1e3):.1f}%), "
          f"{n_kernels / steps:.0f} device kernels per step under "
          f"{len(by_name)} names; top by device time per step:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {us / steps / 1e3:8.4f} ms  {name[:100]}")
    for name, ms in spans.items():
        print(f"  {ms:8.4f} ms ({100 * ms / busy_ms:.1f}% of the busy "
              f"time) in the kernels launched inside `{name}`")
    return busy_ms


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
# phase 3b: the training path
# ---------------------------------------------------------------------------

TB, ROUNDS, EVAL_B, N_CLASSES = 128, 30, 512, 10
WIRE_BYTES_PER_ROUND = 4 * (TB * 512 + TB * 4)     # 2 acts up, 2 grads down
# AdamW's learning rate: at the reference's default 1e-3 the first steps
# move every weight of these 16-layer branches (no batch norm) by about
# its own scale, the loss spikes and the features die, so the run stays
# at chance; 1e-4 trains (PERF.md, Findings)
LR = 1e-4


def _branch_plan(cfg, n_feat: int, wire, mode: str = "vertical",
                 schedule: str | None = None):
    """`Plan(mode=mode)` over two VGG branches cut after FC1: into a dense
    trunk over the concatenated features (vertical), two dense task heads
    (multitask), or a ReLU mid client of `n_feat` and a dense trunk
    (extended_vanilla); the joint round, or under `schedule`."""
    import torch

    from repro_torch import optim
    from repro_torch.api import Plan
    from repro_torch.core.split import Branch
    from repro_torch.nn import convnets as C
    from repro_torch.nn import layers as L

    to = len(cfg.plan) + 1                        # 13 convs, 5 pools, FC1
    branch = Branch(init=lambda g: C.vgg_init(g, cfg)[:to],
                    apply=lambda p, x: C.vgg_apply(p, cfg, x, to_layer=to))

    def dense(n_in):
        return (lambda g: L.dense_init(g, n_in, cfg.n_classes, bias=True),
                L.dense_apply)
    kw = {"vertical": lambda: {"trunk": dense(2 * n_feat)},
          "multitask": lambda: {"heads": (dense(2 * n_feat),) * 2},
          "extended_vanilla": lambda: {
              "mid": (lambda g: L.dense_init(g, 2 * n_feat, n_feat,
                                             bias=True),
                      lambda p, x: torch.relu(L.dense_apply(p, x))),
              "trunk": dense(n_feat)}}[mode]()
    return branch, Plan(mode=mode, branch=branch, n_clients=2,
                        optimizer=optim.adamw(LR), wire=wire,
                        schedule=schedule,
                        microbatches=MICROBATCHES.get(schedule, 1), **kw)


def _modality_batches(torch, gen, n: int, rows: int, n_classes: int,
                      hw: int = 32):
    """`n` two-modality batches {"x": (2, rows, hw, hw, 3), "labels"}: per
    modality a fixed template per class (seeds 1234 + i) plus 0.6 noise,
    the recipe of data/synthetic.py:image_batch, with labels shared."""
    dev = gen.device
    temps = [torch.randn((n_classes, hw, hw, 3), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             1234 + i)) for i in range(2)]
    out = []
    for _ in range(n):
        labels = torch.randint(0, n_classes, (rows,), generator=gen,
                               device=dev)
        x = torch.stack([t[labels] + 0.6 * torch.randn(
            (rows, hw, hw, 3), generator=gen, device=dev) for t in temps])
        out.append({"x": x, "labels": labels})
    return out


def train_path(torch) -> dict:
    from repro_torch.api import leakage_probe, quantize_int8
    from repro_torch.configs.vgg_cifar10 import CONFIG
    from repro_torch.engine import tree_at
    from repro_torch.kernels import ops
    from repro_torch.nn import layers as L
    from repro_torch.nn.module import param_count

    print(f"training path: vertical split, 2 x VGG-16 branches ({CONFIG.name}"
          f", 13 convs + FC1, fp32) -> dense trunk 1024 -> 10, batch {TB} "
          f"per modality, {ROUNDS} rounds, AdamW({LR}), physical int8 wire")
    phys = [quantize_int8(physical=True), leakage_probe()]
    branch, plan = _branch_plan(CONFIG, 512, phys)
    sess = plan.compile()
    sess.init(seed=SEED)
    print(f"  branch params {param_count(tree_at(sess.state['clients'], 0))}"
          f" per client; trunk {param_count(sess.state['server'])}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    batches = _modality_batches(torch, gen, ROUNDS + 5, TB, N_CLASSES)
    ev = _modality_batches(torch, gen, 1, EVAL_B, N_CLASSES)[0]

    report = sess.wire_report(batches[0])      # the meta probe, no kernels
    for r in report:
        print(f"  wire {r['name']} {r['direction']} {r['shape']} "
              f"{r['dtype']}: {r['bytes']} B physical={r['physical']}")
    if sum(r["bytes"] for r in report) != WIRE_BYTES_PER_ROUND or not all(
            r["physical"] for r in report):
        fail(f"wire_report bills {sum(r['bytes'] for r in report)} B per "
             f"round, expected {WIRE_BYTES_PER_ROUND}, all physical")

    # the first round also loads every cuDNN/cuBLAS kernel the round uses
    # (lazily, at first call): it is timed on its own, and the per-round
    # time is that of rounds 2..ROUNDS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    losses = sess.fit(lambda r: batches[r], rounds=1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses += sess.fit(lambda r: batches[r + 1], rounds=ROUNDS - 1)
    end.record()
    end.synchronize()
    wall_s = time.perf_counter() - t0
    round_ms = start.elapsed_time(end) / (ROUNDS - 1)
    fit_launches = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  losses: first 5 {[round(x, 4) for x in losses[:5]]}, last 5 "
          f"{[round(x, 4) for x in losses[-5:]]}")
    print(f"  first round {first_s:.3f} s; then {round_ms:.3f} ms per round "
          f"(CUDA events over rounds 2-{ROUNDS}, host "
          f"{wall_s / (ROUNDS - 1) * 1e3:.3f} ms), "
          f"{TB / round_ms * 1e3:.1f} examples/s ({TB} rows x 2 modalities "
          f"per round), peak {peak_gib:.2f} GiB")
    print(f"  launches over the {ROUNDS} rounds: {fit_launches}")
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite training loss: {losses}")
    if not statistics.mean(losses[-5:]) < statistics.mean(losses[:5]):
        fail(f"loss did not fall: {losses}")
    for name in ("wire_quant", "wire_dequant"):
        if fit_launches[name] != 4 * ROUNDS:
            fail(f"{name}: {fit_launches[name]} launches in {ROUNDS} rounds, "
                 f"expected 4 per round")
    meter = sess.engine.meter
    billed = sum(meter.bytes_up) + sum(meter.bytes_down)
    print(f"  meter: {billed} wire B over {ROUNDS} rounds = "
          f"{billed / ROUNDS:.0f} B per round (fp32 wire "
          f"{4 * 4 * TB * 512} B); {sess.meter()}")
    if billed != ROUNDS * WIRE_BYTES_PER_ROUND:
        fail(f"meter billed {billed} B, expected "
             f"{ROUNDS * WIRE_BYTES_PER_ROUND}")

    # the example's evaluation: the joint accuracy, then the server's trunk
    # over both branches' features through the fused splitcat entry
    acc = float(sess.evaluate(ev))
    st = sess.state
    with torch.no_grad():
        feats = [branch.apply(tree_at(st["clients"], i), ev["x"][i])
                 for i in range(2)]
        n_before = ops.launch_counts()["splitcat_linear"]
        logits = ops.splitcat_linear(feats, st["server"]["w"],
                                     st["server"]["b"])
        fused_launches = ops.launch_counts()["splitcat_linear"] - n_before
        want = L.dense_apply(st["server"], torch.cat(feats, -1))
    launches = ops.launch_counts()
    acc_fused = float((logits.argmax(-1) == ev["labels"]).float().mean())
    err = (logits - want).abs().max().item()
    print(f"  evaluate ({EVAL_B} rows): accuracy {acc:.4f}; fused splitcat "
          f"entry accuracy {acc_fused:.4f}, logits max abs err {err:.3e} "
          f"against the concat trunk; launches on the path {launches}")
    if acc <= 3 / N_CLASSES:
        fail(f"evaluation accuracy {acc} after {ROUNDS} rounds: the branches "
             f"did not learn the class templates (chance is "
             f"{1 / N_CLASSES})")
    if fused_launches != 1:
        fail(f"the fused evaluation launched splitcat_linear "
             f"{fused_launches} times, expected 1")
    if not torch.allclose(logits, want, rtol=1e-5, atol=1e-5) or \
            acc != acc_fused:
        fail("fused splitcat evaluation disagrees with the concat trunk")
    if tuple(logits.shape) != (EVAL_B, N_CLASSES):
        fail(f"logits shape {tuple(logits.shape)}")
    leak = [sess.leakage_report(ev, client=c) for c in (0, 1)]
    print(f"  leakage (distance correlation, raw vs wire): {leak}")

    # where a round's time goes (one round per profiled step)
    it = iter(range(ROUNDS, ROUNDS + 4))
    busy_ms = profile_device(torch, "training round",
                             lambda: sess.run_round(batches[next(it)]),
                             round_ms / 1e3)

    _physical_equals_fake(torch, lambda w: _branch_plan(CONFIG, 512, w)[1],
                          phys, st, batches, 5, "vertical")
    del sess, st
    torch.cuda.empty_cache()
    return {"launches": launches, "first_round_s": first_s,
            "round_ms": round_ms,
            "examples_per_s": TB / round_ms * 1e3,
            "busy_ms": busy_ms, "peak_gib": peak_gib,
            "wire_bytes_per_round": billed // ROUNDS,
            "first_loss": losses[0], "last_loss": losses[-1],
            "eval_accuracy": acc}


# ---------------------------------------------------------------------------
# phase 3c: SSM serving
# ---------------------------------------------------------------------------

SB, SPROMPT, SGEN = 4, 512, 32


def ssm_path(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.nn.module import param_count
    from repro_torch.serve import ServePlan, ServeSession

    cfg = get_config("mamba2_130m")
    print(f"SSM path: {cfg.name} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim}"
          f" SSD heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}, vocab {cfg.vocab}, {cfg.dtype}, cut "
          f"{cfg.default_cut}, batch {SB}, prompt {SPROMPT}, generate {SGEN}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(cfg).init(gen, "cuda")
    torch.cuda.synchronize()
    print(f"init on the card: {time.perf_counter() - t0:.2f} s, "
          f"{param_count(params)} parameters")
    gen.manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (SB, SPROMPT), generator=gen,
                            device="cuda")

    def session(wire):
        return ServeSession(ServePlan(arch=cfg, wire=wire, max_batch=SB,
                                      max_len=SPROMPT + SGEN + 1), params,
                            device="cuda")

    phys = session("quantize_int8:physical")
    phys.generate(prompts, 2)                    # warmup
    torch.cuda.synchronize()

    ops.reset_launches()
    t0 = time.perf_counter()
    tok0 = phys.prefill(prompts)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    rest = phys.decode(tok0, SGEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = ops.launch_counts()
    toks = torch.cat([tok0, rest], dim=1)
    print(f"prefill {t_prefill:.4f} s; decode {SGEN - 1} steps "
          f"{t_decode:.4f} s = {SB * (SGEN - 1) / t_decode:.1f} tok/s; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"launches on the SSM path: {launches}")
    # rmsnorm: each layer's block norm and gated norm, and the final norm,
    # at prefill and at every decode step; ssd_scan: one call per layer at
    # prefill (512 is two whole chunks, no remainder call), none at decode
    # (ssd_decode_step); the wire kernels once per hop each way
    per_forward = 2 * cfg.n_layers + 1
    want = {"rmsnorm": per_forward * SGEN, "rmsnorm_bwd": 0,
            "ssd_scan": cfg.n_layers,
            "wire_quant": 2 * SGEN, "wire_dequant": 2 * SGEN,
            "splitcat_linear_q8": 0, "splitcat_linear": 0,
            "flash_attention": 0}
    hold_launches(launches, want)

    tok = rest[:, -1:]

    def step():
        nonlocal tok
        tok = phys.decode_step(tok)
    busy_ms = profile_device(torch, "SSM decode step", step,
                             t_decode / (SGEN - 1))
    prefill_busy_ms = profile_device(torch, "SSM prefill",
                                     lambda: phys.prefill(prompts),
                                     t_prefill, steps=1)
    if tuple(toks.shape) != (SB, SGEN):
        fail(f"generated shape {tuple(toks.shape)} != {(SB, SGEN)}")
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        fail("generated tokens outside the vocabulary")

    per_tok = phys.bytes_per_token()
    cost = phys.decode_cost(batch=SB)
    up, down = cfg.d_model + 4, cfg.vocab + 4
    dense = session("").bytes_per_token()
    print(f"wire bytes per generated token per row: {per_tok} "
          f"(up {cost.bytes_up // SB}, down {cost.bytes_down // SB}); bf16 "
          f"wire {dense}")
    if per_tok != up + down or per_tok != 51056 or \
            cost.bytes_up + cost.bytes_down != SB * per_tok:
        fail(f"wire bytes per token {per_tok} != analytic {up + down}")
    if dense != cfg.dtype.itemsize * (cfg.d_model + cfg.vocab):
        fail(f"bf16 wire bytes per token {dense}")

    # the physical and the fake wire, from the same weights and prompts
    t_phys = session("quantize_int8:physical").generate(prompts, SGEN)
    t_fake = session("quantize_int8").generate(prompts, SGEN)
    if not torch.equal(t_phys, t_fake):
        fail("SSM physical-wire tokens differ from fake-wire tokens:\n"
             f"{t_phys.tolist()}\n{t_fake.tolist()}")
    print(f"physical wire == fake wire tokens: bitwise ({SB}x{SGEN}); "
          f"{int((t_phys == toks).sum())}/{SB * SGEN} shared with the timed "
          "run")
    del phys, params
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": t_prefill,
            "prefill_busy_ms": prefill_busy_ms,
            "decode_tok_per_s": SB * (SGEN - 1) / t_decode,
            "decode_step_ms": t_decode / (SGEN - 1) * 1e3,
            "busy_ms": busy_ms, "wire_bytes_per_token": per_tok}


def reduced_ssm_against_cpu(torch):
    """A reduced fp32 Mamba2 served on the card (kernels) and on the CPU
    (plain versions) from the same weights over the physical wire, at a
    prompt of 11 (a chunk of 8, then a remainder of 3 from the carried
    state), must generate the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import ServePlan, ServeSession

    cfg = get_config("mamba2_130m").reduced(vocab=97)
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg).init(gen, "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 11), generator=gen)
    plan = ServePlan(arch=cfg, wire="quantize_int8:physical", max_batch=2,
                     max_len=20)
    on_cpu = ServeSession(plan, params, device="cpu").generate(prompts, 6)
    ops.reset_launches()
    on_card = ServeSession(plan, params, device="cuda").generate(prompts, 6)
    n_ssd = ops.launch_counts()["ssd_scan"]
    if n_ssd != 2 * cfg.n_layers:
        fail(f"reduced SSM model: {n_ssd} ssd_scan launches, expected "
             f"{2 * cfg.n_layers} (a chunk and a remainder per layer)")
    if not torch.equal(on_cpu, on_card.cpu()):
        fail(f"reduced SSM model: card tokens {on_card.tolist()} != CPU "
             f"tokens {on_cpu.tolist()}")
    print(f"reduced SSM model, prompt 11, card == CPU plain path: "
          f"{on_cpu.tolist()}")


# ---------------------------------------------------------------------------
# phase 3d: hybrid serving (RG-LRU + local attention)
# ---------------------------------------------------------------------------

HB, HPROMPT, HGEN = 4, 4096, 32
HYBRID_WIRE_BYTES = (2560 + 4) + (256000 + 4)


def hybrid_path(torch) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.nn.module import param_bytes, param_count
    from repro_torch.serve import ServePlan, ServeSession

    cfg = get_config("recurrentgemma_2b")
    model = build_model(cfg)
    n_attn = sum(g.n_repeat * sum(s.mixer == "attn" for s in g.specs)
                 for g in model.groups)
    print(f"hybrid path: {cfg.name} {cfg.n_layers} layers "
          f"{[(g.n_repeat, [s.mixer for s in g.specs]) for g in model.groups]}"
          f", d_model {cfg.d_model}, lru_width {cfg.lru_width}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, window "
          f"{cfg.window}, gelu d_ff {cfg.d_ff}, vocab {cfg.vocab} (untied), "
          f"{cfg.dtype}, cut {cfg.default_cut}, batch {HB}, prompt {HPROMPT}, "
          f"generate {HGEN}")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(gen, "cuda")
    torch.cuda.synchronize()
    print(f"init on the card: {time.perf_counter() - t0:.2f} s, "
          f"{param_count(params)} parameters, "
          f"{param_bytes(params) / 1e9:.3f} GB")
    gen.manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (HB, HPROMPT), generator=gen,
                            device="cuda")

    def session(wire):
        return ServeSession(ServePlan(arch=cfg, wire=wire, max_batch=HB,
                                      max_len=HPROMPT + HGEN + 1), params,
                            device="cuda")

    phys = session("quantize_int8:physical")
    phys.generate(prompts, 2)                    # warmup
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    tok0 = phys.prefill(prompts)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    rest = phys.decode(tok0, HGEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    toks = torch.cat([tok0, rest], dim=1)
    print(f"prefill {t_prefill:.4f} s; decode {HGEN - 1} steps "
          f"{t_decode:.4f} s = {HB * (HGEN - 1) / t_decode:.1f} tok/s; "
          f"peak {peak_gib:.2f} GiB (the prefill's logits at every position "
          f"are {HB * HPROMPT * cfg.vocab * 2 / 2**30:.2f} GiB)")
    print(f"launches on the hybrid path: {launches}")
    # rmsnorm: every block's two norms and the final norm, at prefill and
    # at every decode step; flash_attention: one per attention layer at
    # prefill, none at decode; the wire kernels once per hop each way
    per_forward = 2 * cfg.n_layers + 1
    want = {"rmsnorm": per_forward * HGEN, "rmsnorm_bwd": 0,
            "flash_attention": n_attn,
            "wire_quant": 2 * HGEN, "wire_dequant": 2 * HGEN,
            "splitcat_linear_q8": 0, "splitcat_linear": 0, "ssd_scan": 0}
    hold_launches(launches, want)

    tok = rest[:, -1:]

    def step():
        nonlocal tok
        tok = phys.decode_step(tok)
    busy_ms = profile_device(torch, "hybrid decode step", step,
                             t_decode / (HGEN - 1))
    prefill_busy_ms = profile_device(torch, "hybrid prefill",
                                     lambda: phys.prefill(prompts),
                                     t_prefill, steps=1)
    if tuple(toks.shape) != (HB, HGEN):
        fail(f"generated shape {tuple(toks.shape)} != {(HB, HGEN)}")
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        fail("generated tokens outside the vocabulary")

    per_tok = phys.bytes_per_token()
    cost = phys.decode_cost(batch=HB)
    up, down = cfg.d_model + 4, cfg.vocab + 4
    dense = session("").bytes_per_token()
    print(f"wire bytes per generated token per row: {per_tok} "
          f"(up {cost.bytes_up // HB}, down {cost.bytes_down // HB}); bf16 "
          f"wire {dense}")
    if per_tok != up + down or per_tok != HYBRID_WIRE_BYTES or \
            cost.bytes_up + cost.bytes_down != HB * per_tok:
        fail(f"wire bytes per token {per_tok} != analytic {up + down}")
    if dense != cfg.dtype.itemsize * (cfg.d_model + cfg.vocab):
        fail(f"bf16 wire bytes per token {dense}")

    t_phys = session("quantize_int8:physical").generate(prompts, HGEN)
    t_fake = session("quantize_int8").generate(prompts, HGEN)
    if not torch.equal(t_phys, t_fake):
        fail("hybrid physical-wire tokens differ from fake-wire tokens:\n"
             f"{t_phys.tolist()}\n{t_fake.tolist()}")
    print(f"physical wire == fake wire tokens: bitwise ({HB}x{HGEN}); "
          f"{int((t_phys == toks).sum())}/{HB * HGEN} shared with the timed "
          "run")
    del phys, params
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": t_prefill,
            "decode_tok_per_s": HB * (HGEN - 1) / t_decode,
            "decode_step_ms": t_decode / (HGEN - 1) * 1e3,
            "busy_ms": busy_ms, "prefill_busy_ms": prefill_busy_ms,
            "peak_gib": peak_gib, "wire_bytes_per_token": per_tok}


def reduced_hybrid_against_cpu(torch):
    """A reduced fp32 RecurrentGemma (two super-blocks, window 40) served
    on the card (kernels) and on the CPU (plain versions) from the same
    weights over the physical wire, at a prompt of 150: past the window,
    no multiple of the kernel's 32- and 64-row tiles, so the last query
    tile is ragged and the first KV tile is skipped; the decode steps wrap
    the 40-row ring."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import ServePlan, ServeSession

    cfg = get_config("recurrentgemma_2b").reduced(vocab=97, n_layers=6,
                                                  window=40)
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg).init(gen, "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 150), generator=gen)
    plan = ServePlan(arch=cfg, wire="quantize_int8:physical", max_batch=2,
                     max_len=160)
    on_cpu = ServeSession(plan, params, device="cpu").generate(prompts, 6)
    ops.reset_launches()
    on_card = ServeSession(plan, params, device="cuda").generate(prompts, 6)
    n_flash = ops.launch_counts()["flash_attention"]
    if n_flash != 2:
        fail(f"reduced hybrid model: {n_flash} flash_attention launches, "
             "expected 2 (one per attention layer at prefill)")
    if not torch.equal(on_cpu, on_card.cpu()):
        fail(f"reduced hybrid model: card tokens {on_card.tolist()} != CPU "
             f"tokens {on_cpu.tolist()}")
    print(f"reduced hybrid model, prompt 150, window 40, card == CPU plain "
          f"path: {on_cpu.tolist()}")


# ---------------------------------------------------------------------------
# phases 3e and 3f: the turn kinds (round-robin, p2p handoff)
# ---------------------------------------------------------------------------

VB, V_CLIENTS, V_ROUNDS, V_CUT = 128, 4, 30, 2
# phase 3i: the microbatch count of the pipelined paths (64-row payloads)
MICROBATCHES = {"pipelined": 2}
BASELINES = ("fedavg", "large_batch")
CUT_SHAPE = (VB, 32, 32, 64)
# the (128,32,32,64) fp32 cut as int8 + one fp32 scale a 64-wide row, up
# and down each turn; the handoff's four leaves (3,3,3,64), (64,),
# (3,3,64,64), (64,) the same way
V_CUT_BYTES = VB * 32 * 32 * 64 + VB * 32 * 32 * 4
V_HANDOFF_BYTES = 1836 + 68 + 39168 + 68
# u_shaped cut at (2, 19): the client keeps conv 1-2 and FC2 with the loss,
# so FC1's (128,512) output comes down and its gradient goes up, and the
# handoff also carries FC2's (512,10) weight and (10,) bias
U_CUTS = (2, 19)
U_MID_BYTES = VB * 512 + VB * 4
U_HANDOFF_BYTES = V_HANDOFF_BYTES + (512 * 10 + 512 * 4) + (10 + 4)
# multihop cut at [2, 7]: a relay slab (pool, conv 3-4, pool, conv 5) sends
# its (128,8,8,256) activation on, billed to no data client
M_CUTS = [2, 7]
M_RELAY_SHAPE = (VB, 8, 8, 256)
M_RELAY_BYTES = VB * 8 * 8 * 256 + VB * 8 * 8 * 4
VGG16_PARAMS = 14_982_474
# the client leaves a handoff carries: (leaf, shape, how many)
V_LEAVES = [("conv 1 w", (3, 3, 3, 64), 1), ("biases", (64,), 2),
            ("conv 2 w", (3, 3, 64, 64), 1)]
# per turn kind: its cut arguments at full width and on the SMOKE VGG, the
# wire report a turn [(name, direction, shape, bytes, billed)], the handoff
# bytes and leaves, and the client's parameters
TURN_KINDS = {
    "vanilla": dict(
        cuts={"cut": V_CUT}, smoke={"cut": 2},
        report=[("cut_act", "up", CUT_SHAPE, V_CUT_BYTES, True),
                ("cut_grad", "down", CUT_SHAPE, V_CUT_BYTES, True)],
        handoff=V_HANDOFF_BYTES, handoff_leaves=V_LEAVES,
        client_params=38_720),
    "u_shaped": dict(
        cuts={"cuts": U_CUTS}, smoke={"cuts": (2, 6)},
        report=[("cut_act_1", "up", CUT_SHAPE, V_CUT_BYTES, True),
                ("cut_act_2", "down", (VB, 512), U_MID_BYTES, True),
                ("cut_grad_2", "up", (VB, 512), U_MID_BYTES, True),
                ("cut_grad_1", "down", CUT_SHAPE, V_CUT_BYTES, True)],
        handoff=U_HANDOFF_BYTES,
        handoff_leaves=V_LEAVES + [("FC2 w", (512, 10), 1),
                                   ("FC2 b", (10,), 1)],
        client_params=38_720 + 5_130),
    "multihop": dict(
        cuts={"cuts": M_CUTS}, smoke={"cuts": [2, 4]},
        report=[("hop_0_act", "up", CUT_SHAPE, V_CUT_BYTES, True),
                ("hop_1_act", "up", M_RELAY_SHAPE, M_RELAY_BYTES, False),
                ("hop_1_grad", "down", M_RELAY_SHAPE, M_RELAY_BYTES, False),
                ("hop_0_grad", "down", CUT_SHAPE, V_CUT_BYTES, True)],
        handoff=V_HANDOFF_BYTES, handoff_leaves=V_LEAVES,
        client_params=38_720),
}
NO_OTHER_KERNEL = {"splitcat_linear_q8": 0, "splitcat_linear": 0,
                   "rmsnorm": 0, "rmsnorm_bwd": 0, "ssd_scan": 0,
                   "flash_attention": 0}


def _vgg_segmodel(cfg):
    """The VGG layer list as a `SegModel`."""
    from repro_torch.core.split import list_segmodel
    from repro_torch.nn import convnets as C

    plan = C.vgg_plan(cfg)
    return list_segmodel(len(plan), lambda g: C.vgg_init(g, cfg),
                         lambda p, i, x: C.vgg_layer_apply(p, plan[i], x))


def _turn_plan(cfg, mode: str, wire, n_clients: int, cuts: dict,
               schedule: str | None = None, microbatches: int | None = None):
    """`Plan(mode=...)` of a turn kind over the VGG layer list, under the
    schedule given (None: round-robin) at `microbatches` (None: the
    schedule's count here)."""
    from repro_torch import optim
    from repro_torch.api import Plan

    m = microbatches or MICROBATCHES.get(schedule, 1)
    return Plan(mode=mode, model=_vgg_segmodel(cfg), n_clients=n_clients,
                optimizer=optim.adamw(LR), wire=wire, schedule=schedule,
                microbatches=m, **cuts)


def _client_batches(gen, n: int, n_clients: int, rows: int, n_classes: int,
                    hw: int = 32) -> list:
    """`n` rounds of per-client batches [{"x": (rows, hw, hw, 3),
    "labels"}] * n_clients from `data/synthetic.py:image_batch`."""
    from repro_torch.data.synthetic import image_batch

    out = []
    for _ in range(n):
        bs = [image_batch(gen, rows, n_classes, hw=hw)
              for _ in range(n_clients)]
        out.append([{"x": b["images"], "labels": b["labels"]} for b in bs])
    return out


def _timed_fit(torch, sess, batches, rounds: int):
    """`Session.fit` over `rounds` rounds with launch counters zeroed just
    before: the first round on its own (it also loads every cuDNN/cuBLAS
    kernel the rounds use, lazily), then the rest under CUDA events.
    Returns (losses, first round s, ms a round, host ms a round,
    launches, peak GiB)."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    losses = sess.fit(lambda r: batches[r], rounds=1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses += sess.fit(lambda r: batches[r + 1], rounds=rounds - 1)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) / (rounds - 1) * 1e3
    launches = ops.launch_counts()
    round_ms = start.elapsed_time(end) / (rounds - 1)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  losses: first 5 {[round(x, 4) for x in losses[:5]]}, last 5 "
          f"{[round(x, 4) for x in losses[-5:]]}")
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite training loss: {losses}")
    k = min(5, rounds // 2)            # the first and last 5 (or 1 of 3)
    if not statistics.mean(losses[-k:]) < statistics.mean(losses[:k]):
        fail(f"loss did not fall: {losses}")
    return losses, first_s, round_ms, host_ms, launches, peak_gib


def _physical_equals_fake(torch, make_plan, phys, state, batches,
                          rounds: int, what: str):
    """From one state, `rounds` rounds over the physical and the fake wire
    with deterministic cuDNN: per-turn losses and the final state
    bitwise equal."""
    from repro_torch.api import quantize_int8

    _runs_equal(torch, {"physical wire": make_plan(phys),
                        "fake wire": make_plan([quantize_int8()])},
                state, batches, rounds, what)


def _runs_equal(torch, plans: dict, state, batches, rounds: int, what: str):
    """From one state, `rounds` rounds of each of two plans with
    deterministic cuDNN: per-turn losses, the final state and the meter
    bitwise equal."""
    from repro_torch.engine import copy_tree
    from repro_torch.nn.module import tree_leaves

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    runs = []
    for plan in plans.values():
        s2 = plan.compile()
        s2.state = copy_tree(state)
        ls = torch.cat([s2.run_round(batches[r]) for r in range(rounds)])
        runs.append((ls, s2.state, s2.meter()))
    torch.backends.cudnn.deterministic = False
    (la, sa, ma), (lb, sb, mb) = runs
    same_state = all(torch.equal(a, b) for a, b in
                     zip(tree_leaves(sa), tree_leaves(sb), strict=True))
    a, b = plans
    if not torch.equal(la, lb) or not same_state or ma != mb:
        fail(f"{what}: {a} losses {la.tolist()} != {b} losses "
             f"{lb.tolist()} (states equal: {same_state}; meters {ma}, "
             f"{mb})")
    print(f"  {a} == {b} over {rounds} rounds, deterministic cuDNN: "
          f"losses, final state and meter bitwise ({la.tolist()})")


def turn_path(torch, mode: str, schedule: str | None = None) -> dict:
    """Full-width VGG-16 as a turn kind (vanilla, u_shaped or multihop), 4
    clients over the physical wire: round-robin with the p2p handoff, or
    under `schedule` (parallel: SplitFed, no handoff; pipelined: the
    round-robin with each turn as M microbatches)."""
    from repro_torch.api import leakage_probe, quantize_int8
    from repro_torch.configs.vgg_cifar10 import CONFIG
    from repro_torch.data.synthetic import image_batch
    from repro_torch.engine import tree_at
    from repro_torch.nn.module import param_count

    spec, m = TURN_KINDS[mode], MICROBATCHES.get(schedule, 1)
    turns = V_CLIENTS * V_ROUNDS
    how = {None: "round-robin with the p2p handoff",
           "parallel": "in parallel (SplitFed: one server step a round on "
                       "the mean cut gradient, no handoff)",
           "pipelined": f"round-robin with the p2p handoff, each turn as "
                        f"{m} microbatches of {VB // m} rows"}[schedule]
    print(f"{path_name(mode, schedule).replace('_', ' ')} path: "
          f"{CONFIG.name} (13 convs + FC1 + FC2, fp32) cut at "
          f"{spec['cuts']}, {V_CLIENTS} clients {how}, batch {VB} per "
          f"client per turn, {V_ROUNDS} rounds ({turns} turns), "
          f"AdamW({LR}), physical int8 wire")
    phys = [quantize_int8(physical=True), leakage_probe()]

    def make_plan(wire):
        return _turn_plan(CONFIG, mode, wire, V_CLIENTS, spec["cuts"],
                          schedule)
    sess = make_plan(phys).compile()
    sess.init(seed=SEED)
    n_client = param_count(tree_at(sess.state["clients"], 0))
    n_server = param_count(sess.state["server"])
    print(f"  client params {n_client} per client; server {n_server}; "
          f"model {n_client + n_server}")
    if (n_client, n_client + n_server) != (spec["client_params"],
                                           VGG16_PARAMS):
        fail(f"{mode}: {n_client} client / {n_client + n_server} model "
             f"parameters, expected {spec['client_params']} / "
             f"{VGG16_PARAMS}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    batches = _client_batches(gen, V_ROUNDS + 1, V_CLIENTS, VB, N_CLASSES)
    ev = image_batch(gen, EVAL_B, N_CLASSES)
    ev = {"x": ev["images"], "labels": ev["labels"]}

    # the meta probe, no kernels: the full batch's records, whatever the
    # microbatch count (M payloads of B/M rows carry the bytes of one)
    report = sess.wire_report(batches[0])
    for r in report:
        print(f"  wire {r['name']} {r['direction']} {r['shape']} "
              f"{r['dtype']}: {r['bytes']} B physical={r['physical']}")
    want = [w[:4] for w in spec["report"]]
    if [(r["name"], r["direction"], r["shape"], r["bytes"])
            for r in report] != want or not all(r["physical"]
                                                for r in report):
        fail(f"{mode} wire_report {report}: expected {want}, all physical")

    losses, first_s, round_ms, host_ms, launches, peak_gib = _timed_fit(
        torch, sess, batches, V_ROUNDS)
    print(f"  first round {first_s:.3f} s; then {round_ms:.3f} ms per round, "
          f"{round_ms / V_CLIENTS:.3f} ms per turn (CUDA events over rounds "
          f"2-{V_ROUNDS}, host {host_ms:.3f} ms per round), "
          f"{VB * V_CLIENTS / round_ms * 1e3:.1f} examples/s, peak "
          f"{peak_gib:.2f} GiB")
    print(f"  launches over the {V_ROUNDS} rounds: {launches}")
    # the wire kernels: once a crossing of a microbatch every turn (relay
    # hops too), and once a client leaf at every handoff taken (none under
    # the parallel schedule)
    leaves = sum(k for _, _, k in spec["handoff_leaves"])
    per_kernel = len(spec["report"]) * m * turns + (
        0 if schedule == "parallel" else leaves * (turns - 1))
    hold_launches(launches, {"wire_quant": per_kernel,
                             "wire_dequant": per_kernel, **NO_OTHER_KERNEL})

    meter = sess.engine.meter
    up = sum(w[3] for w in spec["report"] if w[4] and w[1] == "up")
    down = sum(w[3] for w in spec["report"] if w[4] and w[1] == "down")
    h = ([0] * V_CLIENTS if schedule == "parallel"
         else [V_ROUNDS - 1] + [V_ROUNDS] * (V_CLIENTS - 1))
    want_gb = [(V_ROUNDS * (up + down) + k * spec["handoff"]) / 1e9
               for k in h]
    totals = sess.meter()
    print(f"  meter: up {meter.bytes_up}, down {meter.bytes_down}, handoff "
          f"{meter.sync_bytes} B; {totals}")
    if (meter.bytes_up != [V_ROUNDS * up] * V_CLIENTS
            or meter.bytes_down != [V_ROUNDS * down] * V_CLIENTS
            or meter.sync_bytes != [k * spec["handoff"] for k in h]
            or totals["client_gb"] != want_gb):
        fail(f"{mode} meter {totals['client_gb']} GB, expected {want_gb} "
             f"({up} + {down} billed wire B a turn, {spec['handoff']} B a "
             f"handoff)")

    accs = sess.evaluate_all(ev).tolist()
    print(f"  evaluate_all ({EVAL_B} held-out rows): {accs}")
    if len(accs) != V_CLIENTS or min(accs) < 3 / N_CLASSES:
        fail(f"{mode}: evaluation accuracies {accs} after {V_ROUNDS} rounds, "
             f"below three times chance ({1 / N_CLASSES})")
    if sess.engine.topology.client_fwd is not None:
        leak = sess.leakage_report(ev, client=0)
        print(f"  leakage (distance correlation, raw vs wire): {leak}")

    # where a round's time goes: one profiled round of V_CLIENTS turns
    busy_ms = profile_device(torch, f"{mode} round ({V_CLIENTS} turns)",
                             lambda: sess.run_round(batches[V_ROUNDS]),
                             round_ms / 1e3, steps=1)
    _physical_equals_fake(torch, make_plan, phys, sess.state, batches, 3,
                          path_name(mode, schedule))
    del sess
    torch.cuda.empty_cache()
    return {"launches": launches, "first_round_s": first_s,
            "round_ms": round_ms, "turn_ms": round_ms / V_CLIENTS,
            "examples_per_s": VB * V_CLIENTS / round_ms * 1e3,
            "busy_ms": busy_ms, "peak_gib": peak_gib,
            "wire_bytes_per_turn": up + down,
            "handoff_bytes": spec["handoff"],
            "meter": [meter.bytes_up, meter.bytes_down, meter.sync_bytes],
            "client_tflops": statistics.mean(totals["client_tflops"]),
            "client_gb": statistics.mean(totals["client_gb"]),
            "first_loss": losses[0], "last_loss": losses[-1],
            "eval_accuracy": accs}


def _reduced_against_cpu(torch, what: str, make_plan, batches):
    """One plan on the card (kernels) and on the CPU (plain versions) from
    the same state, 3 rounds over the physical wire: per-turn losses and
    the whole final state allclose, meters equal."""
    from repro_torch.nn.module import tree_leaves, tree_map

    rtol, atol = 1e-4, 1e-5
    on_cpu = make_plan().compile(device="cpu")
    on_card = make_plan().compile()
    on_cpu.init(seed=3)
    on_card.state = tree_map(lambda t: t.to("cuda"), on_cpu.state)
    l_card = torch.cat([on_card.run_round(b) for b in batches]).cpu()
    l_cpu = torch.cat([on_cpu.run_round(b) for b in batches])
    pairs = list(zip(tree_leaves(on_card.state), tree_leaves(on_cpu.state)))
    worst = max((a.cpu().double() - b.double()).abs().max().item()
                for a, b in pairs)
    print(f"reduced {what}, card vs CPU plain path: losses "
          f"{l_card.tolist()} vs {l_cpu.tolist()}; largest state "
          f"difference {worst:.3e}")
    if not torch.allclose(l_card, l_cpu, rtol=rtol, atol=atol):
        fail(f"reduced {what}: card losses differ from the CPU's")
    if not all(torch.allclose(a.cpu(), b, rtol=rtol, atol=atol)
               for a, b in pairs):
        fail(f"reduced {what}: final state differs beyond rtol {rtol}, "
             f"atol {atol}")
    if on_card.meter() != on_cpu.meter():
        fail(f"reduced {what}: card meter {on_card.meter()} != CPU meter "
             f"{on_cpu.meter()}")


def reduced_turn_against_cpu(torch, mode: str, schedule: str | None = None):
    """SMOKE VGG as the turn kind `mode`, 3 clients, batch 8."""
    from repro_torch.api import quantize_int8
    from repro_torch.configs.vgg_cifar10 import SMOKE

    batches = _client_batches(torch.Generator().manual_seed(4), 3, 3, 8,
                              SMOKE.n_classes)
    _reduced_against_cpu(
        torch, path_name(mode, schedule).replace("_", " "),
        lambda: _turn_plan(SMOKE, mode, [quantize_int8(physical=True)], 3,
                           TURN_KINDS[mode]["smoke"], schedule), batches)


# ---------------------------------------------------------------------------
# phase 3g: configuration (ii), the branch kinds on two VGG-16 branches
# ---------------------------------------------------------------------------

# the wire records of a branch kind's round, in order
BRANCH_RECORDS = {
    "vertical": ["branch_0_act", "branch_1_act", "branch_0_grad",
                 "branch_1_grad"],
    "multitask": ["branch_0_act", "branch_1_act", "branch_0_grad",
                  "branch_1_grad"],
    "extended_vanilla": ["branch_0_act", "branch_1_act", "mid_act",
                         "mid_grad", "branch_0_grad", "branch_1_grad"]}


# At round 30 extended_vanilla (and multitask's lower task, in the joint
# round) is still on the steep part of its learning curve: over repeated
# runs on the card its held-out accuracy straddles three times chance,
# and by round 60 it is at or near 1.0 (chip_spread.py measures it;
# PERF.md). These paths' launches, meter and loss are held over the 30
# timed rounds; then each trains this many more rounds, on batches drawn
# after the held-out rows, before its accuracy is checked.
EXTRA_ROUNDS = {"multitask": 30, "extended_vanilla": 30}


def _task_labels(torch, batch, n_classes: int = N_CLASSES):
    """Two tasks' labels (2, rows): task 1's are (labels + 1) % n_classes,
    as tests/test_api.py:modal_batch makes them."""
    labels = batch["labels"]
    return {**batch, "labels": torch.stack([labels,
                                            (labels + 1) % n_classes])}


def branch_path(torch, mode: str, schedule: str | None = None) -> dict:
    """`Plan(mode=mode)` over the vertical slice's two VGG-16 branches (13
    convs + FC1, 512 features each) over the physical wire, 30 rounds:
    the joint round, or under `schedule` (pipelined: M microbatches)."""
    from repro_torch.api import leakage_probe, quantize_int8
    from repro_torch.configs.vgg_cifar10 import CONFIG

    names, m = BRANCH_RECORDS[mode], MICROBATCHES.get(schedule, 1)
    server = {"vertical": "a 1024 -> 10 trunk",
              "multitask": "two 1024 -> 10 heads, task 1's labels "
                           "(labels + 1) % 10",
              "extended_vanilla": "a 1024 -> 512 ReLU mid client -> a "
                                  "512 -> 10 trunk"}[mode]
    print(f"{path_name(mode, schedule).replace('_', ' ')} path: 2 x VGG-16 "
          f"branches ({CONFIG.name}, 13 convs + FC1, fp32) -> {server}, "
          f"batch {TB} per modality"
          + (f" as {m} microbatches of {TB // m}" if m > 1 else "")
          + f", {ROUNDS} rounds, AdamW({LR}), physical int8 wire")
    phys = [quantize_int8(physical=True), leakage_probe()]

    def make_plan(wire):
        return _branch_plan(CONFIG, 512, wire, mode, schedule)[1]
    sess = make_plan(phys).compile()
    sess.init(seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    batches = _modality_batches(torch, gen, ROUNDS + 5, TB, N_CLASSES)
    ev = _modality_batches(torch, gen, 1, EVAL_B, N_CLASSES)[0]
    if mode == "multitask":
        batches = [_task_labels(torch, b) for b in batches]
        ev = _task_labels(torch, ev)

    report = sess.wire_report(batches[0])      # the meta probe, no kernels
    for r in report:
        print(f"  wire {r['name']} {r['direction']} {r['shape']} "
              f"{r['dtype']}: {r['bytes']} B physical={r['physical']}")
    if [r["name"] for r in report] != names or any(
            r["shape"] != (TB, 512) or r["bytes"] != TB * 512 + TB * 4
            or not r["physical"] for r in report):
        fail(f"{mode} wire_report {report}: expected {names}, each "
             f"({TB},512) at {TB * 512 + TB * 4} B, physical")

    losses, first_s, round_ms, host_ms, launches, peak_gib = _timed_fit(
        torch, sess, batches, ROUNDS)
    print(f"  first round {first_s:.3f} s; then {round_ms:.3f} ms per round "
          f"(CUDA events over rounds 2-{ROUNDS}, host {host_ms:.3f} ms), "
          f"{TB / round_ms * 1e3:.1f} examples/s, peak {peak_gib:.2f} GiB")
    print(f"  launches over the {ROUNDS} rounds: {launches}")
    per_kernel = len(names) * m * ROUNDS      # every crossing a microbatch
    hold_launches(launches, {"wire_quant": per_kernel,
                             "wire_dequant": per_kernel, **NO_OTHER_KERNEL})
    meter = sess.engine.meter
    billed = sum(meter.bytes_up) + sum(meter.bytes_down)
    print(f"  meter: {billed} wire B over {ROUNDS} rounds = "
          f"{billed / ROUNDS:.0f} B per round; {sess.meter()}")
    if billed != ROUNDS * WIRE_BYTES_PER_ROUND:
        fail(f"{mode} meter billed {billed} B, expected "
             f"{ROUNDS * WIRE_BYTES_PER_ROUND}")
    extra = EXTRA_ROUNDS.get(mode, 0)
    if extra:
        more = _modality_batches(torch, gen, extra, TB, N_CLASSES)
        if mode == "multitask":
            more = [_task_labels(torch, b) for b in more]
        more_losses = sess.fit(lambda r: more[r], rounds=extra)
        print(f"  {extra} more rounds before the accuracy check: last 5 "
              f"losses {[round(x, 4) for x in more_losses[-5:]]}")

    acc = float(sess.evaluate(ev))
    accs = [acc]
    if mode == "multitask":     # each task on its own
        with torch.no_grad():
            st = sess.state
            logits = sess.engine.topology.evaluate(st["clients"],
                                                   st["server"], ev)
        accs = (logits.argmax(-1) == ev["labels"]).float().mean(-1).tolist()
    print(f"  evaluate ({EVAL_B} held-out rows): {acc:.4f}"
          + (f"; by task {accs}" if mode == "multitask" else ""))
    if min(accs) <= 3 / N_CLASSES:
        fail(f"{mode}: evaluation accuracy {accs} after {ROUNDS + extra} "
             f"rounds, not above three times chance ({1 / N_CLASSES})")
    # the label dcor over one task's labels
    labels = ev["labels"][0] if mode == "multitask" else ev["labels"]
    leak = sess.leakage_report({**ev, "labels": labels}, client=0)
    print(f"  leakage (distance correlation, raw vs wire): {leak}")
    it = iter(range(ROUNDS, ROUNDS + 4))
    busy_ms = profile_device(torch, f"{mode} round",
                             lambda: sess.run_round(batches[next(it)]),
                             round_ms / 1e3)
    _physical_equals_fake(torch, make_plan, phys, sess.state, batches, 3,
                          path_name(mode, schedule))
    del sess
    torch.cuda.empty_cache()
    return {"launches": launches, "first_round_s": first_s,
            "round_ms": round_ms, "examples_per_s": TB / round_ms * 1e3,
            "busy_ms": busy_ms, "peak_gib": peak_gib,
            "wire_bytes_per_round": billed // ROUNDS,
            "first_loss": losses[0], "last_loss": losses[-1],
            "eval_accuracy": accs}


def reduced_branch_against_cpu(torch, mode: str, schedule: str | None = None):
    """SMOKE VGG branches as the branch kind `mode`, batch 8, hw 16."""
    from repro_torch.api import quantize_int8
    from repro_torch.configs.vgg_cifar10 import SMOKE

    batches = _modality_batches(torch, torch.Generator().manual_seed(4), 3,
                                8, SMOKE.n_classes, hw=16)
    if mode == "multitask":
        batches = [_task_labels(torch, b, SMOKE.n_classes) for b in batches]
    _reduced_against_cpu(
        torch, path_name(mode, schedule).replace("_", " "),
        lambda: _branch_plan(SMOKE, 128, [quantize_int8(physical=True)],
                             mode, schedule)[1], batches)


# ---------------------------------------------------------------------------
# phase 3h: the paper's comparison, fedavg and large-batch SGD
# ---------------------------------------------------------------------------

F_LOCAL_STEPS = 2
# VGG-16's 30 leaves as int8 + one fp32 scale a last-axis row, against
# 4 bytes a parameter dense
MODEL_WIRE_BYTES, MODEL_DENSE_BYTES = 15_120_370, 4 * VGG16_PARAMS


def _baseline_plan(cfg, mode: str, wire, n_clients: int,
                   schedule: str | None = None):
    from repro_torch import optim
    from repro_torch.api import Plan

    return Plan(mode=mode, model=_vgg_segmodel(cfg), n_clients=n_clients,
                optimizer=optim.adamw(LR), wire=wire,
                local_steps=F_LOCAL_STEPS if mode == "fedavg" else 1,
                schedule=schedule,
                microbatches=MICROBATCHES.get(schedule, 1))


def baseline_path(torch, mode: str, schedule: str | None = None) -> dict:
    """Full-width VGG-16 under fedavg (2 local steps) or large-batch SGD,
    4 clients of 128 rows, 30 rounds, the model pulled and pushed through
    the physical wire; under the pipelined schedule each client's
    gradient is the mean over M microbatches."""
    from repro_torch.api import leakage_probe, quantize_int8
    from repro_torch.configs.vgg_cifar10 import CONFIG
    from repro_torch.data.synthetic import image_batch
    from repro_torch.nn.module import param_count, tree_leaves

    m = MICROBATCHES.get(schedule, 1)
    print(f"{path_name(mode, schedule).replace('_', ' ')} path: "
          f"{CONFIG.name} (fp32), {V_CLIENTS} clients, batch {VB} per client"
          + (f" as {m} microbatches of {VB // m}" if m > 1 else "")
          + f", {V_ROUNDS} rounds"
          + (f" of {F_LOCAL_STEPS} local steps" if mode == "fedavg" else "")
          + f", AdamW({LR}), the model pulled and pushed over the physical "
          "int8 wire")
    phys = [quantize_int8(physical=True), leakage_probe()]

    def make_plan(wire):
        return _baseline_plan(CONFIG, mode, wire, V_CLIENTS, schedule)
    sess = make_plan(phys).compile()
    sess.init(seed=SEED)
    n_leaves = len(tree_leaves(sess.state["global"]))
    if param_count(sess.state["global"]) != VGG16_PARAMS or n_leaves != 30:
        fail(f"{mode}: {param_count(sess.state['global'])} parameters in "
             f"{n_leaves} leaves, expected {VGG16_PARAMS} in 30")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    batches = _client_batches(gen, V_ROUNDS + 1, V_CLIENTS, VB, N_CLASSES)
    ev = image_batch(gen, EVAL_B, N_CLASSES)
    ev = {"x": ev["images"], "labels": ev["labels"]}

    report = sess.wire_report(batches[0])      # meta tensors, no kernels
    print(f"  wire report: {report}; dense model "
          f"{sess.engine._param_bytes} B")
    want = [{"name": "model_pull", "direction": "down",
             "bytes": MODEL_WIRE_BYTES, "physical": True},
            {"name": "model_push", "direction": "up",
             "bytes": MODEL_WIRE_BYTES, "physical": True}]
    if report != want or sess.engine._param_bytes != MODEL_DENSE_BYTES:
        fail(f"{mode} wire_report {report} (dense "
             f"{sess.engine._param_bytes} B), expected {want} "
             f"({MODEL_DENSE_BYTES} B dense)")

    losses, first_s, round_ms, host_ms, launches, peak_gib = _timed_fit(
        torch, sess, batches, V_ROUNDS)
    passes = V_CLIENTS * (F_LOCAL_STEPS if mode == "fedavg" else 1)
    print(f"  first round {first_s:.3f} s; then {round_ms:.3f} ms per round "
          f"({passes} forward and backward passes; CUDA events over rounds "
          f"2-{V_ROUNDS}, host {host_ms:.3f} ms), peak {peak_gib:.2f} GiB")
    print(f"  launches over the {V_ROUNDS} rounds: {launches}")
    # 30 leaves pulled, then 30 stacked (4, ...) leaves pushed, a round
    hold_launches(launches, {"wire_quant": 2 * n_leaves * V_ROUNDS,
                             "wire_dequant": 2 * n_leaves * V_ROUNDS,
                             **NO_OTHER_KERNEL})
    meter = sess.engine.meter
    totals = sess.meter()
    print(f"  meter: up {meter.bytes_up}, down {meter.bytes_down} B "
          f"({2 * MODEL_WIRE_BYTES} B a client a round); {totals}")
    if (meter.bytes_up != [V_ROUNDS * MODEL_WIRE_BYTES] * V_CLIENTS
            or meter.bytes_down != meter.bytes_up
            or meter.sync_bytes != [0] * V_CLIENTS
            or totals["client_gb"] != [V_ROUNDS * 2 * MODEL_WIRE_BYTES
                                       / 1e9] * V_CLIENTS):
        fail(f"{mode} meter {totals['client_gb']} GB, expected "
             f"{2 * MODEL_WIRE_BYTES} B a client a round")

    acc = float(sess.evaluate(ev))
    print(f"  evaluate, the global model ({EVAL_B} held-out rows): "
          f"{acc:.4f}")
    if acc <= 3 / N_CLASSES:
        fail(f"{mode}: evaluation accuracy {acc} after {V_ROUNDS} rounds, "
             f"not above three times chance ({1 / N_CLASSES})")
    busy_ms = profile_device(torch, f"{mode} round",
                             lambda: sess.run_round(batches[V_ROUNDS]),
                             round_ms / 1e3, steps=1)
    _physical_equals_fake(torch, make_plan, phys, sess.state, batches, 3,
                          path_name(mode, schedule))
    del sess
    torch.cuda.empty_cache()
    return {"launches": launches, "first_round_s": first_s,
            "round_ms": round_ms,
            "examples_per_s": VB * V_CLIENTS / round_ms * 1e3,
            "busy_ms": busy_ms, "peak_gib": peak_gib,
            "model_wire_bytes": MODEL_WIRE_BYTES,
            "client_tflops": statistics.mean(totals["client_tflops"]),
            "client_gb": statistics.mean(totals["client_gb"]),
            "first_loss": losses[0], "last_loss": losses[-1],
            "eval_accuracy": acc}


def reduced_baseline_against_cpu(torch, mode: str,
                                 schedule: str | None = None):
    """The whole SMOKE VGG under `mode`, 3 clients, batch 8."""
    from repro_torch.api import quantize_int8
    from repro_torch.configs.vgg_cifar10 import SMOKE

    batches = _client_batches(torch.Generator().manual_seed(4), 3, 3, 8,
                              SMOKE.n_classes)
    _reduced_against_cpu(
        torch, path_name(mode, schedule).replace("_", " "),
        lambda: _baseline_plan(SMOKE, mode, [quantize_int8(physical=True)],
                               3, schedule), batches)


def table1(vanilla: dict, fedavg: dict, large_batch: dict):
    """The paper's Table 1 comparison as measured here (the meters over
    each run: 30 rounds of 4 clients x 128 rows), beside the analytic
    rows of `paper_table1_setup(4)` (50,000 rows, 100 epochs)."""
    from repro_torch.core.accounting import paper_table1_setup

    for name, res in (("splitNN (vanilla, cut 2)", vanilla),
                      ("fedavg (2 local steps)", fedavg),
                      ("large_batch", large_batch)):
        print(f"table 1, measured: {name}: client TFLOPs "
              f"{res['client_tflops']:.6f}, client GB {res['client_gb']:.6f} "
              f"(mean over {V_CLIENTS} clients, {V_ROUNDS} rounds)")
    for cut in (1, 2):
        t = paper_table1_setup(V_CLIENTS, cut_layer=cut)
        print(f"table 1, analytic paper_table1_setup({V_CLIENTS}, "
              f"cut_layer={cut}): splitNN {t.splitnn()}, fedavg "
              f"{t.fedavg()}, large_batch {t.lbsgd()}")
    if not vanilla["client_tflops"] < large_batch["client_tflops"]:
        fail(f"splitNN's client TFLOPs {vanilla['client_tflops']} are not "
             f"below large_batch's {large_batch['client_tflops']}")


# ---------------------------------------------------------------------------
# phase 3i: the schedules (parallel, pipelined)
# ---------------------------------------------------------------------------

def schedules_phase(torch, default: dict) -> dict:
    """Every turn kind in parallel, every mode pipelined at M=2, each with
    its reduced card == CPU check, then vanilla pipelined at M=1 against
    round-robin.  `default` holds each mode's own-schedule result (phases
    3b, 3e-3h), for the meter comparison and the time ratios."""
    out = {}
    for mode in TURN_KINDS:
        for schedule in ("parallel", "pipelined"):
            out[(mode, schedule)] = turn_path(torch, mode, schedule)
            reduced_turn_against_cpu(torch, mode, schedule)
    for mode in BRANCH_RECORDS:
        out[(mode, "pipelined")] = branch_path(torch, mode, "pipelined")
        reduced_branch_against_cpu(torch, mode, "pipelined")
    for mode in BASELINES:
        out[(mode, "pipelined")] = baseline_path(torch, mode, "pipelined")
        reduced_baseline_against_cpu(torch, mode, "pipelined")
    for (mode, schedule), res in out.items():
        base = default[mode]
        if schedule == "pipelined" and mode in TURN_KINDS and \
                res["meter"] != base["meter"]:
            fail(f"{mode} pipelined meter {res['meter']} != round-robin "
                 f"meter {base['meter']}")
        print(f"schedule {mode} {schedule}: {res['round_ms']:.3f} ms a "
              f"round against its own schedule's {base['round_ms']:.3f} ms "
              f"({res['round_ms'] / base['round_ms']:.3f}x); device busy "
              f"{res['busy_ms']} ms a round; peak {res['peak_gib']:.2f} GiB")
    print("pipelined meters == round-robin meters, byte for byte (sync "
          "bytes included)")
    pipelined_m1_equals_round_robin(torch)
    return out


def pipelined_m1_equals_round_robin(torch):
    """Vanilla at full width, pipelined with one microbatch against
    round-robin, 3 rounds from one state over the same batches."""
    from repro_torch.api import quantize_int8
    from repro_torch.configs.vgg_cifar10 import CONFIG

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    batches = _client_batches(gen, 3, V_CLIENTS, VB, N_CLASSES)
    plans = {name: _turn_plan(CONFIG, "vanilla",
                              [quantize_int8(physical=True)], V_CLIENTS,
                              TURN_KINDS["vanilla"]["cuts"], schedule, 1)
             for name, schedule in (("pipelined (M=1)", "pipelined"),
                                    ("round-robin", None))}
    sess = plans["round-robin"].compile()
    sess.init(seed=SEED)
    print("vanilla pipelined M=1 against round-robin (full width):")
    _runs_equal(torch, plans, sess.state, batches, 3, "vanilla pipelined M=1")


# ---------------------------------------------------------------------------
# phase 3j: LM split training (Mamba2-130M and phi4-mini at full width)
# ---------------------------------------------------------------------------

# batch x sequence a turn (Mamba2's 512 rows are two SSD chunks), rounds
LB, LS, L_ROUNDS = 4, 512, 30
# the token ids the LM batches draw from (`lm_batch`'s noisy bigram rule
# over the first LM_DATA_VOCAB ids; the models keep their full vocab and
# their logits cover it).  Over the full vocabulary the rule walks through
# ids that recur about once in 30 rounds, and 30 AdamW steps from a random
# init learn nothing there (chip_lm_vocab.py measures both; PERF.md)
LM_DATA_VOCAB = 1024
# arch -> (layers kept, None for all; cut; clients).  Mamba2-130M keeps
# 12 of its 24 layers and phi4-mini 2 of its 32, at full width, to keep
# the whole run inside its time limit; in fp32 phi4-mini's 32 layers
# would not fit one 80 GB card anyway (the 614.6M-row tied embedding held
# by the client and, as `tied_head`, by the server, with their gradients
# and AdamW moments)
LM_RUNS = {"mamba2_130m": (12, 4, 2), "phi4_mini_3_8b": (2, 1, 1)}
# the LM paths: (arch, mode, schedule, rounds); the other schedules and
# the baseline run 3 rounds of Mamba2
LM_PATHS = [("mamba2_130m", "vanilla", None, L_ROUNDS),
            ("phi4_mini_3_8b", "vanilla", None, L_ROUNDS),
            ("mamba2_130m", "vanilla", "pipelined", 3),
            ("mamba2_130m", "vanilla", "parallel", 3),
            ("mamba2_130m", "large_batch", None, 3)]
# the reduced card == CPU checks: arch -> (reduced overrides, seq, cut);
# RecurrentGemma's sequence runs past its window
LM_REDUCED = {"phi4_mini_3_8b": (dict(vocab=64), 12, 1),
              "mamba2_130m": (dict(vocab=64), 16, 1),
              "recurrentgemma_2b": (dict(vocab=64, n_layers=6, window=8),
                                    20, 3)}


def _lm_config(torch, arch):
    """The full-width config in fp32, cut to its kept layers."""
    import dataclasses

    from repro_torch.configs import get_config

    layers = LM_RUNS[arch][0]
    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def _lm_leaves(torch, arch, side: str) -> list:
    """The leaf shapes of the client's tree (side "client") or of the whole
    model ("model"), from an init on meta tensors."""
    from repro_torch.models import build_model
    from repro_torch.nn.module import tree_leaves

    model = build_model(_lm_config(torch, arch))
    params = model.init(torch.Generator(), "meta")
    if side == "client":
        params = model.split_params(params, LM_RUNS[arch][1])[0]
    return [tuple(t.shape) for t in tree_leaves(params)]


def _int8_bytes(shapes) -> int:
    """Leaves through the int8 wire: one byte a value plus one fp32 scale
    a last-axis row."""
    return sum(math.prod(s) + 4 * (math.prod(s) // s[-1]) for s in shapes)


def _lm_path_name(arch, mode, schedule=None) -> str:
    return path_name(f"{arch}_{mode}", schedule)


def _lm_payloads(torch) -> list:
    """Every payload the LM paths hand the wire kernels, with their
    launches a run: a vanilla turn's cut activation up and gradient down
    once a microbatch (rows / M), the client's leaves at every handoff
    taken (every turn but the first, with more than one client, none in
    parallel); a large_batch round every model leaf pulled and pushed
    stacked over the clients."""
    from collections import Counter

    f32, out = torch.float32, []
    for arch, mode, schedule, rounds in LM_PATHS:
        name = _lm_path_name(arch, mode, schedule)
        n, m = LM_RUNS[arch][2], MICROBATCHES.get(schedule, 1)
        d = _lm_config(torch, arch).d_model
        if mode == "large_batch":
            for shape, k in Counter(_lm_leaves(torch, arch,
                                               "model")).items():
                out += [(name, "model pull", shape, f32, (k * rounds,) * 2),
                        (name, "model push", (n,) + shape, f32,
                         (k * rounds,) * 2)]
            continue
        turns = n * rounds
        out.append((name, "cut_act up / cut_grad down", (LB // m, LS, d),
                    f32, (2 * m * turns,) * 2))
        if n > 1 and schedule != "parallel":
            out += [(name, "handoff", shape, f32, (k * (turns - 1),) * 2)
                    for shape, k in Counter(_lm_leaves(
                        torch, arch, "client")).items()]
    return out


def _lm_plan(torch, arch, wire, mode="vanilla", schedule=None):
    """`Plan` of an LM: vanilla over `lm_split_fns` at the run's cut, or a
    baseline over `FullFns(model.init, model.forward)`."""
    from repro_torch import optim
    from repro_torch.api import FullFns, Plan, lm_split_fns
    from repro_torch.models import build_model

    _, cut, n = LM_RUNS[arch]
    model = build_model(_lm_config(torch, arch))
    kw = dict(optimizer=optim.adamw(LR), wire=wire, n_clients=n,
              schedule=schedule, microbatches=MICROBATCHES.get(schedule, 1))
    if mode == "vanilla":
        return Plan(mode=mode, model=lm_split_fns(model, cut), cut=cut,
                    **kw)
    return Plan(mode=mode, model=FullFns(model.init, model.forward), **kw)


def _lm_batches(gen, n: int, n_clients: int, rows: int, seq: int,
                vocab: int) -> list:
    """`n` rounds of per-client `data/synthetic.py:lm_batch`es."""
    from repro_torch.data.synthetic import lm_batch

    return [[lm_batch(gen, rows, seq, vocab) for _ in range(n_clients)]
            for _ in range(n)]


def _lm_launches(torch, arch, mode, schedule, rounds) -> dict:
    """Every kernel's launches over `rounds` rounds, as the code implies.
    A forward launches rmsnorm twice a block with an MLP (norm1, norm2),
    twice a Mamba2 block (norm1 and the gated norm) and once for the
    final norm, ssd_scan once a Mamba2 block and flash_attention once an
    attention block.  Its backward launches RMS_BWD_KERNELS rmsnorm_bwd
    kernels for each of its rmsnorms (x and scale both need a gradient)
    and nothing for the SSD and flash (their Functions recompute the
    plain versions).  A pipelined turn runs the client's forward twice a
    microbatch, the staged one without a graph and the backward's
    recompute, which alone is differentiated, and the server's once."""
    cfg = _lm_config(torch, arch)
    _, cut, n = LM_RUNS[arch]
    m = MICROBATCHES.get(schedule, 1)
    mamba = cfg.family == "ssm"

    def fwd(layers, final, differentiated=True):
        norms = 2 * layers + final
        return {"rmsnorm": norms,
                "rmsnorm_bwd": RMS_BWD_KERNELS * norms * differentiated,
                "ssd_scan": layers if mamba else 0,
                "flash_attention": 0 if mamba else layers}
    wire = {}
    if mode == "large_batch":
        per_round = [fwd(cfg.n_layers, 1)] * n
        leaves = len(_lm_leaves(torch, arch, "model"))
        wire = {k: 2 * leaves * rounds for k in ("wire_quant",
                                                 "wire_dequant")}
    else:
        staged = [fwd(cut, 0, False)] * m if schedule == "pipelined" else []
        per_round = ([fwd(cut, 0)] * m + staged
                     + [fwd(cfg.n_layers - cut, 1)] * m) * n
        turns = n * rounds
        handoffs = (turns - 1 if n > 1 and schedule != "parallel" else 0)
        k = 2 * m * turns + handoffs * len(_lm_leaves(torch, arch, "client"))
        wire = {"wire_quant": k, "wire_dequant": k}
    out = {k: rounds * sum(f[k] for f in per_round)
           for k in ("rmsnorm", "rmsnorm_bwd", "ssd_scan", "flash_attention")}
    return {**wire, **out, "splitcat_linear_q8": 0, "splitcat_linear": 0}


def _lm_runs_equal(torch, make_plan, batches, rounds: int, what: str):
    """From one seeded init, `rounds` rounds over the physical and the fake
    wire under deterministic algorithms (embedding and gather backward
    accumulate with atomics on CUDA otherwise): per-turn losses, the whole
    final state and the meter bitwise equal.  The first run's state waits
    on the host, so the card holds one run at a time."""
    from repro_torch.api import leakage_probe, quantize_int8
    from repro_torch.nn.module import tree_leaves

    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for wire in ([quantize_int8(physical=True), leakage_probe()],
                     [quantize_int8()]):
            s = make_plan(wire).compile()
            s.init(seed=SEED)
            ls = torch.cat([s.run_round(batches[r]) for r in range(rounds)])
            leaves = tree_leaves(s.state)
            runs.append((ls.cpu(), [t.cpu() for t in leaves] if not runs
                         else leaves, s.meter()))
            del s, leaves
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    (la, sa, ma), (lb, sb, mb) = runs
    same = len(sa) == len(sb) and all(torch.equal(a, b.cpu())
                                      for a, b in zip(sa, sb))
    if not torch.equal(la, lb) or not same or ma != mb:
        fail(f"{what}: physical wire losses {la.tolist()} != fake wire "
             f"losses {lb.tolist()} (states equal: {same}; meters {ma}, "
             f"{mb})")
    print(f"  physical wire == fake wire over {rounds} rounds, "
          f"deterministic algorithms: losses, final state and meter "
          f"bitwise ({la.tolist()})")
    del runs, sa, sb
    torch.cuda.empty_cache()


def _lm_client_grads(torch, sess, batch, what: str):
    """One vanilla turn's gradients on the trained state, at the run's
    shapes: client 0's leaves against the server's.  Every leaf of the
    client's layers gets a finite nonzero gradient, and its embedding one
    on exactly the rows of the turn's token ids, so autograd reached the
    client through every kernel above it.  The falling loss cannot show
    this: with tied embeddings the server's head and final norm lower it
    by themselves."""
    from repro_torch.engine import tree_at
    from repro_torch.nn.module import tree_leaves

    eng = sess.engine
    _, g_c, _ = eng.topology.turn_grads(tree_at(sess.state["clients"], 0),
                                        sess.state["server"], batch,
                                        eng.loss_fn)
    norms = [float(g.norm()) for g in tree_leaves(g_c["groups"])]
    emb = g_c["embed"]["table"]
    used = torch.zeros(emb.shape[0], dtype=torch.bool, device=emb.device)
    used[batch["tokens"].flatten()] = True
    rows = emb.abs().amax(dim=-1) > 0
    print(f"  client 0's gradient on the trained state: {len(norms)} layer "
          f"leaves, norms {min(norms):.3e} to {max(norms):.3e}; embedding "
          f"rows with a gradient {int(rows.sum())}, the turn's ids "
          f"{int(used.sum())}")
    if not (norms and all(math.isfinite(v) and v > 0 for v in norms)
            and torch.equal(rows, used)):
        fail(f"{what}: the client's gradient did not reach every leaf: "
             f"layer norms {norms}, embedding rows {int(rows.sum())} with "
             f"a gradient against {int(used.sum())} ids in the turn")
    del g_c, emb


def lm_path(torch, arch, mode="vanilla", schedule=None,
            rounds=L_ROUNDS) -> dict:
    """One LM training path on the card over the physical wire: vanilla
    (round-robin with the p2p handoff, or under `schedule`) or the
    large_batch baseline over `FullFns`."""
    from repro_torch.api import leakage_probe, quantize_int8
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.engine import tree_at
    from repro_torch.nn.module import param_count

    cfg = _lm_config(torch, arch)
    _, cut, n = LM_RUNS[arch]
    m = MICROBATCHES.get(schedule, 1)
    name = _lm_path_name(arch, mode, schedule)
    how = (f"cut {cut}, {n} client{'s' if n > 1 else ''} "
           + {None: "round-robin" + (" with the p2p handoff" if n > 1
                                     else ""),
              "parallel": "in parallel (SplitFed)",
              "pipelined": f"round-robin with the p2p handoff, each turn "
                           f"as {m} microbatches"}[schedule]
           if mode == "vanilla" else f"{n} clients, the whole model pulled "
           "and pushed")
    print(f"{name.replace('_', ' ')} path: {cfg.name} {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab}, fp32, {mode} {how}, "
          f"batch {LB} x seq {LS} per client (token ids below "
          f"{LM_DATA_VOCAB}), {rounds} rounds, AdamW({LR}), "
          "physical int8 wire")
    phys = [quantize_int8(physical=True), leakage_probe()]

    def make_plan(wire):
        return _lm_plan(torch, arch, wire, mode, schedule)
    torch.cuda.reset_peak_memory_stats()
    sess = make_plan(phys).compile()
    sess.init(seed=SEED)
    if mode == "vanilla":
        n_client = param_count(tree_at(sess.state["clients"], 0))
        n_server = param_count(sess.state["server"])
        print(f"  client params {n_client}; server {n_server}")
    else:
        print(f"  model params {param_count(sess.state['global'])}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    batches = _lm_batches(gen, rounds + 1, n, LB, LS, LM_DATA_VOCAB)
    ev = lm_batch(gen, LB, LS, LM_DATA_VOCAB)

    report = sess.wire_report(batches[0])       # meta tensors, no kernels
    d = cfg.d_model
    if mode == "vanilla":
        cut_bytes = LB * LS * (d + 4)
        want = [("cut_act", "up", (LB, LS, d), cut_bytes),
                ("cut_grad", "down", (LB, LS, d), cut_bytes)]
        got = [(r["name"], r["direction"], r["shape"], r["bytes"])
               for r in report]
    else:
        model_bytes = _int8_bytes(_lm_leaves(torch, arch, "model"))
        want = [("model_pull", "down", model_bytes),
                ("model_push", "up", model_bytes)]
        got = [(r["name"], r["direction"], r["bytes"]) for r in report]
    print(f"  wire report: {got}")
    if got != want or not all(r["physical"] for r in report):
        fail(f"{name} wire_report {report}: expected {want}, all physical")

    losses, first_s, round_ms, host_ms, launches, peak_gib = _timed_fit(
        torch, sess, batches, rounds)
    print(f"  first round {first_s:.3f} s; then {round_ms:.3f} ms per round "
          f"(CUDA events over rounds 2-{rounds}, host {host_ms:.3f} ms), "
          f"{LB * LS * n / round_ms * 1e3:.1f} tokens/s, peak "
          f"{peak_gib:.2f} GiB")
    print(f"  launches over the {rounds} rounds: {launches}")
    hold_launches(launches, _lm_launches(torch, arch, mode, schedule,
                                         rounds))

    meter, totals = sess.engine.meter, sess.meter()
    print(f"  meter: up {meter.bytes_up}, down {meter.bytes_down}, handoff "
          f"{meter.sync_bytes} B; {totals}")
    if mode == "vanilla":
        handoff = _int8_bytes(_lm_leaves(torch, arch, "client"))
        h = ([0] * n if schedule == "parallel" or n == 1
             else [rounds - 1] + [rounds] * (n - 1))
        want_m = ([rounds * cut_bytes] * n, [rounds * cut_bytes] * n,
                  [k * handoff for k in h])
        want_gb = [(rounds * 2 * cut_bytes + k * handoff) / 1e9 for k in h]
        if any(h):
            print(f"  handoff {handoff} B a handoff (the analytic sum over "
                  f"the client's leaves)")
    else:
        want_m = ([rounds * model_bytes] * n, [rounds * model_bytes] * n,
                  [0] * n)
        want_gb = [rounds * 2 * model_bytes / 1e9] * n
    metered = [list(meter.bytes_up), list(meter.bytes_down),
               list(meter.sync_bytes)]         # before the profiled round
    if tuple(metered) != want_m or totals["client_gb"] != want_gb:
        fail(f"{name} meter {totals['client_gb']} GB, expected {want_gb}")

    acc = float(sess.evaluate(ev))
    print(f"  evaluate (next-token accuracy on {LB} x {LS} held-out "
          f"tokens): {acc:.4f}")
    if mode == "vanilla":
        print(f"  leakage (distance correlation, tokens vs wire): "
              f"{sess.leakage_report(ev)}")
    busy_ms = profile_device(torch, f"{name} round",
                             lambda: sess.run_round(batches[rounds]),
                             round_ms / 1e3, steps=1)
    if mode == "vanilla":
        _lm_client_grads(torch, sess, batches[0][0], name)
    del sess
    torch.cuda.empty_cache()
    if schedule is None and mode == "vanilla":
        _lm_runs_equal(torch, make_plan, batches, 3, name)
    return {"launches": launches, "first_round_s": first_s,
            "round_ms": round_ms, "tokens_per_s": LB * LS * n / round_ms * 1e3,
            "busy_ms": busy_ms, "peak_gib": peak_gib, "meter": metered,
            "client_gb": statistics.mean(totals["client_gb"]),
            "client_tflops": statistics.mean(totals["client_tflops"]),
            "first_loss": losses[0], "last_loss": losses[-1],
            "eval_accuracy": acc}


def reduced_lm_against_cpu(torch, arch):
    """A reduced LM trained on the card (kernels; the Functions' plain
    backward) and on the CPU (plain versions), 2 clients round-robin with
    the p2p handoff over the dense wire, SGD with momentum (as the CPU
    parity tests: tests/test_torch_lm_plan.py says why AdamW and the
    quantized wires part runs by whole steps and levels)."""
    from repro_torch import optim
    from repro_torch.configs import get_config

    red, seq, cut = LM_REDUCED[arch]
    cfg = get_config(arch).reduced(**red)
    batches = _lm_batches(torch.Generator().manual_seed(4), 3, 2, 2, seq,
                          cfg.vocab)

    def make_plan():
        from repro_torch.api import Plan, lm_split_fns
        from repro_torch.models import build_model

        return Plan(mode="vanilla", model=lm_split_fns(build_model(cfg), cut),
                    cut=cut, n_clients=2, optimizer=optim.sgd(0.02, 0.9))
    _reduced_against_cpu(torch, f"{arch} vanilla LM", make_plan, batches)


def lm_phase(torch) -> dict:
    """Phase 3j: every LM path, the pipelined meter against round-robin's,
    and the three families' reduced card == CPU checks."""
    from repro_torch.api import quantize_int8

    out = {(arch, mode, schedule): lm_path(torch, arch, mode, schedule,
                                           rounds)
           for arch, mode, schedule, rounds in LM_PATHS}
    # the round-robin schedule over the same 3 rounds' batch shapes
    sess = _lm_plan(torch, "mamba2_130m", [quantize_int8(physical=True)]
                    ).compile()
    sess.init(seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    for b in _lm_batches(gen, 3, LM_RUNS["mamba2_130m"][2], LB, LS,
                         LM_DATA_VOCAB):
        sess.run_round(b)
    meter = sess.engine.meter
    rr = [meter.bytes_up, meter.bytes_down, meter.sync_bytes]
    del sess, meter
    torch.cuda.empty_cache()
    pipe = out[("mamba2_130m", "vanilla", "pipelined")]["meter"]
    if pipe != rr:
        fail(f"Mamba2 pipelined meter {pipe} != round-robin meter {rr} over "
             "the same 3 rounds")
    print(f"Mamba2 pipelined (M=2) meter == round-robin's over the same 3 "
          f"rounds, byte for byte: {pipe}")
    for arch in LM_REDUCED:
        reduced_lm_against_cpu(torch, arch)
    return out


# ---------------------------------------------------------------------------
# phase 3k: the training CLI (`python -m repro_torch.launch.train`)
# ---------------------------------------------------------------------------

# batch x sequence a client, the steps of the round-robin runs and of the
# others
CLI_B, CLI_S, CLI_STEPS, CLI_SHORT = 8, 512, 30, 3
CLI_WIRE = "quantize_int8:physical,dp_noise:0.05"
# RecurrentGemma-2B keeps 8 of its 26 layers: (rglru, rglru, attn) x 2 +
# (rglru, rglru), the full model's tail (the CLI cuts at 3, a super-block
# boundary); Mamba2-130M 12 of its 24.  Both
# are depth cuts that keep the whole run inside its time limit.  In bf16
# with AdamW, whose functional update holds the old and the new fp32
# moments at once, a stored parameter takes about 22 bytes (weight,
# gradient and new weight in bf16, four fp32 moments), so RecurrentGemma's
# 3.51B (the untied 655M-row embedding and head) would need about 77 GB
# before activations and the (8, 512, 256000) logits (PERF.md)
CLI_RG_LAYERS, CLI_MAMBA2_LAYERS = 8, 12
# the CLI's batches span the whole vocabulary, as the reference's do, and
# 30 steps from a random init learn nothing there (chip_lm_vocab.py); the
# runs here draw their ids below LM_DATA_VOCAB, as phase 3j's do
CLI_DATA_VOCAB = LM_DATA_VOCAB


def cli_config(torch, arch):
    """The full-width config a CLI run of phase 3k trains, in its own
    dtype (bf16): RecurrentGemma cut to `CLI_RG_LAYERS` layers, Mamba2 to
    `CLI_MAMBA2_LAYERS`."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    depth = {"recurrentgemma_2b": CLI_RG_LAYERS,
             "mamba2_130m": CLI_MAMBA2_LAYERS}.get(arch)
    return dataclasses.replace(cfg, n_layers=depth) if depth else cfg


# (path, arch, argv, steps): the Mamba2 runs, then RecurrentGemma.  The
# first Mamba2 run writes its checkpoints; the seq-64 run keeps the CLI's
# default --seq, whose 64 rows are one 64-row SSD chunk (chunk
# min(256, 64))
CLI_RUNS = [
    ("mamba2_130m_cli_split", "mamba2_130m",
     ["--mode", "split", "--n-clients", "2", "--wire", CLI_WIRE], CLI_STEPS),
    ("mamba2_130m_cli_split_parallel", "mamba2_130m",
     ["--mode", "split", "--n-clients", "2", "--wire", CLI_WIRE,
      "--schedule", "parallel"], CLI_SHORT),
    ("mamba2_130m_cli_split_pipelined", "mamba2_130m",
     ["--mode", "split", "--n-clients", "2", "--wire", CLI_WIRE,
      "--schedule", "pipelined", "--microbatches", "2"], CLI_SHORT),
    ("mamba2_130m_cli_monolithic", "mamba2_130m", ["--mode", "monolithic"],
     CLI_SHORT),
    ("mamba2_130m_cli_fedavg", "mamba2_130m",
     ["--mode", "fedavg", "--n-clients", "2", "--local-steps", "2"],
     CLI_SHORT),
    ("mamba2_130m_cli_large_batch", "mamba2_130m",
     ["--mode", "large_batch", "--n-clients", "2"], CLI_SHORT),
    ("mamba2_130m_cli_split_seq64", "mamba2_130m",
     ["--mode", "split", "--n-clients", "2", "--wire", CLI_WIRE], CLI_SHORT),
    ("recurrentgemma_2b_cli_split", "recurrentgemma_2b",
     ["--mode", "split", "--n-clients", "1", "--wire",
      "quantize_int8:physical"], CLI_STEPS),
]
CLI_CKPT_RUNS = ("mamba2_130m_cli_split", "mamba2_130m_cli_monolithic")


def _cli_argv(path, arch, argv, steps) -> list:
    seq = [] if path.endswith("seq64") else ["--seq", str(CLI_S)]
    out = ["--arch", arch, "--batch", str(CLI_B), "--steps", str(steps),
           "--log-every", "0"] + seq + argv
    if path in CLI_CKPT_RUNS:
        out += ["--ckpt", str(ROOT / "build" / "ckpt" / path)]
    return out


def _cli_args(torch, argv, cfg):
    """The CLI's parsed flags, with the cut it defaults to."""
    from repro_torch.launch import train

    a = train.parser().parse_args(argv)
    if a.cut < 0:
        a.cut = min(cfg.default_cut, max(1, cfg.n_layers // 2))
    return a


def _cli_leaves(torch, cfg, cut=None) -> list:
    """(shape, dtype) of each leaf of the model, or of its client side at
    `cut`, from an init on meta tensors."""
    from repro_torch.models import build_model
    from repro_torch.nn.module import tree_leaves

    model = build_model(cfg)
    params = model.init(torch.Generator(), "meta")
    if cut is not None:
        params = model.split_params(params, cut)[0]
    return [(tuple(t.shape), t.dtype) for t in tree_leaves(params)]


def _cli_plan(torch, path, arch, argv, steps, cfg=None) -> dict:
    """What a CLI run must show, worked out from its flags and shapes (of
    `cfg`, by default `cli_config`'s): the mode, clients, microbatches and
    turns; the wire's payloads with their launches a run and its bytes;
    every kernel's launches."""
    from collections import Counter

    cfg = cli_config(torch, arch) if cfg is None else cfg
    a = _cli_args(torch, _cli_argv(path, arch, argv, steps), cfg)
    n, split = a.n_clients, a.mode == "split"
    m = a.microbatches if a.schedule == "pipelined" else 1
    noise = "dp_noise" in a.wire
    kinds = ([cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
             if cfg.pattern else ["ssm" if cfg.family == "ssm" else "mla"
                                  if cfg.attn_kind == "mla" else "attn"]
             * cfg.n_layers)
    # rmsnorm calls a layer: the block's two, and an MLA layer's kv_norm
    # and, with a q LoRA, its q_norm
    norms_of = {"mla": 3 + int(cfg.q_lora_rank > 0)}

    def fwd(lo, hi, final, k=1, differentiated=True):
        """k forwards of layers [lo, hi) (+ the final norm); a
        differentiated one's backward launches RMS_BWD_KERNELS kernels an
        rmsnorm (x and scale both need a gradient)."""
        ks = kinds[lo:hi]
        norms = k * (sum(norms_of.get(x, 2) for x in ks) + final)
        return Counter({"rmsnorm": norms,
                        "rmsnorm_bwd": RMS_BWD_KERNELS * norms
                        * differentiated,
                        "ssd_scan": k * ks.count("ssm"),
                        "flash_attention": k * sum(x in ("attn", "mla")
                                                   for x in ks)})
    L = cfg.n_layers
    if split:
        # a pipelined turn's staged client forwards keep no graph: only
        # the backward's recompute of each microbatch is differentiated
        staged = a.schedule == "pipelined"
        per_round = Counter()
        for _ in range(n):
            per_round += (fwd(0, a.cut, 0, m) + fwd(a.cut, L, 1, m)
                          + fwd(0, a.cut, 0, m if staged else 0, False))
        evals = Counter()
        for _ in range(n):
            evals += fwd(0, L, 1, differentiated=False)
    else:
        k = {"monolithic": 1, "large_batch": n,
             "fedavg": n * a.local_steps}[a.mode]
        per_round, evals = fwd(0, L, 1, k), fwd(0, L, 1, differentiated=False)
    launches = Counter()
    for _ in range(steps):
        launches += per_round
    launches += evals
    payloads, cut_bytes, handoff = [], 0, 0
    turns = n * steps
    wire_k = 0
    if split and a.wire:
        rows = (CLI_B // m, a.seq, cfg.d_model)
        cut_bytes = CLI_B * a.seq * (cfg.d_model + 4)
        k = 2 * m * turns * (2 if noise else 1)
        payloads.append((path, "cut_act up / cut_grad down"
                         + (" (and the noised re-pack)" if noise else ""),
                         rows, cfg.dtype, (k, k)))
        wire_k += k
        leaves = _cli_leaves(torch, cfg, a.cut)
        handoff = _int8_bytes([s for s, _ in leaves])
        if n > 1 and a.schedule != "parallel":
            for (shape, dt), c in Counter(leaves).items():
                payloads.append((path, "handoff", shape, dt,
                                 (c * (turns - 1),) * 2))
                wire_k += c * (turns - 1)
    want = {"wire_quant": wire_k, "wire_dequant": wire_k,
            "splitcat_linear_q8": 0, "splitcat_linear": 0,
            **{k: launches[k] for k in ("rmsnorm", "rmsnorm_bwd", "ssd_scan",
                                        "flash_attention")}}
    h = ([0] * n if a.schedule == "parallel" or n == 1
         else [steps - 1] + [steps] * (n - 1))
    gb = [round((steps * 2 * cut_bytes + k * handoff) / 1e9, 6) for k in h]
    return {"cfg": cfg, "args": a, "payloads": payloads, "launches": want,
            "cut_bytes": cut_bytes, "handoff": handoff, "client_gb": gb}


def _cli_payloads(torch) -> list:
    return [p for run in CLI_RUNS for p in _cli_plan(torch, *run)["payloads"]]


def _run_cli(torch, argv, cfg, data_vocab=CLI_DATA_VOCAB):
    """`repro_torch.launch.train.main(argv)` with its stdout captured and
    echoed: (the run, its JSON summary parsed from the last line)."""
    import contextlib
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = train.main(argv, cfg=cfg, data_vocab=data_vocab)
    lines = buf.getvalue().strip().splitlines()
    for line in lines[:-1]:
        print(f"  | {line}")
    try:
        summary = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"CLI {argv}: the last line is not a JSON object: {lines[-1:]}")
    if len(lines) < 2 or not lines[-2].startswith("eval acc/client: ["):
        fail(f"CLI {argv}: no `eval acc/client` line before the JSON line")
    return run, summary


def _cli_checkpoint(torch, run, path):
    """The run's checkpoints restore bitwise into its own state on the
    card: the stacked clients and the server, or the global model."""
    from repro_torch import bridge
    from repro_torch import checkpoint as ckpt
    from repro_torch.nn.module import tree_leaves

    state, prefix = run.session.state, ROOT / "build" / "ckpt" / path
    if run.session.is_split:
        pairs = [(".clients", bridge.lm_tree_to_ref(state["clients"],
                                                     axis=1)),
                 (".server", bridge.lm_tree_to_ref(state["server"]))]
    else:
        pairs = [("", bridge.lm_tree_to_ref(state["global"]))]
    n = 0
    for suffix, tree in pairs:
        got = ckpt.restore(str(prefix) + suffix, tree)
        man = ckpt.load_manifest(str(prefix) + suffix)
        for a, b in zip(tree_leaves(got), tree_leaves(tree), strict=True):
            if a.device != b.device or a.dtype != b.dtype or not \
                    torch.equal(a, b):
                fail(f"{path}: checkpoint {suffix or 'global'} does not "
                     f"restore bitwise ({a.dtype} {a.device} vs {b.dtype} "
                     f"{b.device})")
            n += 1
        if man["step"] != run.summary["steps"]:
            fail(f"{path}: manifest step {man['step']}")
    bf16 = sum(1 for suffix, _ in pairs for v in ckpt.load_manifest(
        str(prefix) + suffix)["leaves"].values() if v["dtype"] == "bfloat16")
    print(f"  checkpoint{'s' if len(pairs) > 1 else ''} "
          f"{', '.join(p or 'global' for p, _ in pairs)}: {n} leaves "
          f"({bf16} bf16 as raw 16-bit patterns) restore bitwise on the card")


def _cli_runs_equal(torch, arch, cfg, argv_of):
    """3 steps of the CLI over the physical and the fake wire (no
    dp_noise) under deterministic algorithms: losses, the final state and
    the meter bitwise equal.  The first run's state waits on the host."""
    from repro_torch.nn.module import tree_leaves

    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for wire in ("quantize_int8:physical", "quantize_int8"):
            run, _ = _run_cli(torch, argv_of(wire), cfg)
            leaves = tree_leaves(run.session.state)
            runs.append((run.losses, [t.cpu() for t in leaves] if not runs
                         else leaves, run.session.meter()))
            del run, leaves
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    (la, sa, ma), (lb, sb, mb) = runs
    same = len(sa) == len(sb) and all(torch.equal(a, b.cpu())
                                      for a, b in zip(sa, sb))
    if la != lb or not same or ma != mb:
        fail(f"{arch} CLI: physical wire losses {la} != fake wire losses "
             f"{lb} (states equal: {same}; meters {ma}, {mb})")
    print(f"  {arch} CLI, physical wire == fake wire over 3 steps, "
          f"deterministic algorithms: losses, final state ({len(sa)} leaves) "
          f"and meter bitwise ({la})")
    del runs, sa, sb
    torch.cuda.empty_cache()


def cli_path(torch, path, arch, argv, steps, cfg=None) -> dict:
    """One run of the training CLI on the card, in-process through
    `main(argv)` (with `cfg`, by default `cli_config`'s): the JSON line,
    launches, bytes, the falling loss, ms a round, the busy share and the
    peak."""
    from repro_torch.kernels import ops
    from repro_torch.nn.module import param_count

    spec = _cli_plan(torch, path, arch, argv, steps, cfg)
    cfg, a = spec["cfg"], spec["args"]
    full = _cli_argv(path, arch, argv, steps)
    print(f"{path.replace('_', ' ')} path: python -m repro_torch.launch.train "
          f"{' '.join(full)} ({cfg.name}, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, bf16; ids below "
          f"{CLI_DATA_VOCAB})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    run, summary = _run_cli(torch, full, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    state = run.session.state
    params = (param_count(state["clients"]) // a.n_clients
              + param_count(state["server"]) if run.session.is_split
              else param_count(state["global"]))
    held = "client + server" if a.mode == "split" else "global"
    print(f"  {params} stored parameters ({held}); the run {wall:.3f} s, "
          f"peak {peak:.2f} GiB")
    print(f"  launches: {launches}")
    hold_launches(launches, spec["launches"])
    ls = run.losses
    if not all(map(math.isfinite, ls)) or (summary["first_loss"], summary[
            "final_loss"]) != (ls[0], ls[-1]):
        fail(f"{path}: losses {ls}, summary {summary}")
    if steps == CLI_STEPS and not ls[-1] < ls[0]:
        fail(f"{path}: final loss {ls[-1]} not below the first {ls[0]}")
    if a.mode == "split":
        if summary["client_gb"] != spec["client_gb"] or summary[
                "client_gb"] != [round(g, 6) for g in
                                 run.session.meter()["client_gb"]]:
            fail(f"{path}: client_gb {summary['client_gb']}, expected "
                 f"{spec['client_gb']} (cut {spec['cut_bytes']} B each way "
                 f"a turn, handoff {spec['handoff']} B)")
        want = [{"name": nm, "direction": d,
                 "shape": [CLI_B, a.seq, cfg.d_model], "dtype": "bfloat16",
                 "bytes": spec["cut_bytes"], "physical": True}
                for nm, d in (("cut_act", "up"), ("cut_grad", "down"))]
        cost = run.session.engine.turn_cost(
            state, run.session._prep(run.round_batches(0)))
        if summary["wire_report"] != want or [w.bytes for w in cost.wires] \
                != [spec["cut_bytes"]] * 2:
            fail(f"{path}: wire_report {summary['wire_report']}, expected "
                 f"{want}")
        print(f"  wire: {spec['cut_bytes']} B each way a turn"
              + (f", handoff {spec['handoff']} B" if a.n_clients > 1
                 and a.schedule != "parallel" else "")
              + f"; client_gb {summary['client_gb']} exact")
    if path in CLI_CKPT_RUNS:
        _cli_checkpoint(torch, run, path)

    # ms a round and the busy share, past the run: 2 rounds under CUDA
    # events, then one profiled (each round replaces the session's state,
    # so no reference to the old one may stay: RecurrentGemma's fills
    # the card)
    del state
    bs = [run.session._prep(run.round_batches(steps + 2 + i))
          for i in range(3)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in bs[:2]:
        run.session.run_round(b)
    end.record()
    end.synchronize()
    round_ms = start.elapsed_time(end) / 2
    busy_ms = profile_device(torch, f"{path} round",
                             lambda: run.session.run_round(bs[2]),
                             round_ms / 1e3, steps=1)
    tokens = CLI_B * a.seq * (a.n_clients if a.mode != "monolithic" else 1)
    print(f"  {round_ms:.3f} ms a round (CUDA events over 2 rounds), "
          f"{tokens / round_ms * 1e3:.1f} tokens/s; first loss "
          f"{ls[0]:.4f}, final {ls[-1]:.4f}")
    del run, bs
    torch.cuda.empty_cache()
    return {"launches": launches, "round_ms": round_ms, "busy_ms": busy_ms,
            "peak_gib": peak, "wall_s": wall, "params": params,
            "first_loss": ls[0], "final_loss": ls[-1],
            "eval_acc_per_client": summary["eval_acc_per_client"],
            "client_gb": summary.get("client_gb")}


def cli_module_run(torch):
    """The CLI as its own process (`python -m repro_torch.launch.train`,
    the GPU by default): 2 steps of Mamba2 split over the physical wire
    at the default batch and sequence; its last line parses."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "mamba2_130m", "--mode", "split", "--n-clients", "2", "--steps",
           "2", "--wire", "quantize_int8:physical", "--log-every", "1"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"python -m repro_torch.launch.train exited "
             f"{proc.returncode}: {proc.stderr[-2000:]}")
    summary = json.loads(lines[-1])
    print(f"python -m repro_torch.launch.train (its own process, "
          f"{time.perf_counter() - t0:.1f} s): {lines[-2]}; {lines[-1]}")
    if summary["arch"] != "mamba2-130m" or len(summary["client_gb"]) != 2:
        fail(f"python -m repro_torch.launch.train: summary {summary}")


def reduced_cli_against_cpu(torch):
    """phi4-mini at 32 layers does not fit one card (4 layers do, phase
    3j), so the CLI takes it `--reduced`: its JSON line on the card and on
    the CPU (`wire_report`, `client_gb` and the keys exactly equal; each
    side draws its own init), then the CLI's plan (`build_plan`) on the
    card against the CPU from one state over 3 rounds, with SGD with
    momentum and the dense wire in place of the CLI's AdamW and int8
    wire, as phase 3j's card == CPU checks (AdamW and int8 levels part
    runs by whole steps and levels)."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.launch import train
    from repro_torch.models import build_model

    argv = ["--arch", "phi4_mini_3_8b", "--reduced", "--mode", "split",
            "--n-clients", "2", "--steps", "2", "--log-every", "0",
            "--wire", "quantize_int8:physical"]
    out = {dev: _run_cli(torch, argv + ["--device", dev], None, None)[1]
           for dev in ("cuda", "cpu")}
    same = ("wire_report", "client_gb")
    if list(out["cuda"]) != list(out["cpu"]) or any(
            out["cuda"][k] != out["cpu"][k] for k in same):
        fail(f"reduced phi4-mini CLI: card summary {out['cuda']} != CPU "
             f"summary {out['cpu']} in {same} or its keys")
    print(f"reduced phi4-mini CLI, card == CPU: the JSON keys, wire_report "
          f"and client_gb {out['cuda']['client_gb']}")
    args = train.parser().parse_args(argv)
    cfg = train.arch_config(args)
    args.cut = min(cfg.default_cut, max(1, cfg.n_layers // 2))
    args.wire = ""
    batches = _lm_batches(torch.Generator().manual_seed(4), 3, 2, 2, 12,
                          cfg.vocab)

    def make_plan():
        return dataclasses.replace(train.build_plan(build_model(cfg), args),
                                   optimizer=optim.sgd(0.02, 0.9))
    _reduced_against_cpu(torch, "phi4-mini CLI plan", make_plan, batches)


def cli_phase(torch) -> dict:
    """Phase 3k: every CLI run, the physical == fake checks of the stacks
    without dp_noise, the CLI as its own process, and reduced phi4-mini
    through the CLI on the card against the CPU."""
    out = {}
    for run in CLI_RUNS:
        out[run[0]] = cli_path(torch, *run)
    for arch in ("mamba2_130m", "recurrentgemma_2b"):
        n = "2" if arch == "mamba2_130m" else "1"
        _cli_runs_equal(
            torch, arch, cli_config(torch, arch),
            lambda wire, arch=arch, n=n: [
                "--arch", arch, "--batch", str(CLI_B), "--seq", str(CLI_S),
                "--steps", "3", "--log-every", "0", "--mode", "split",
                "--n-clients", n, "--wire", wire])
    cli_module_run(torch)
    reduced_cli_against_cpu(torch)
    return out


# ---------------------------------------------------------------------------
# phase 3k (d): ResNet-CIFAR100, vanilla over the physical wire
# ---------------------------------------------------------------------------

# the stem conv and the first block's two convs, each weight and bias
R_LEAVES = [("stem w", (3, 3, 3, 64), 1), ("biases", (64,), 3),
            ("block 1 c1/c2 w", (3, 3, 64, 64), 2)]
R_HANDOFF_BYTES = _int8_bytes([s for _, s, k in R_LEAVES for _ in range(k)])
R_CLASSES = 100


def _resnet_plan(cfg, wire, n_clients):
    from repro_torch import optim
    from repro_torch.api import Plan
    from repro_torch.core.split import list_segmodel
    from repro_torch.nn import convnets as C

    plan = C.resnet_plan(cfg)
    seg = list_segmodel(len(plan), lambda g: C.resnet_init(g, cfg),
                        lambda p, i, x: C.resnet_layer_apply(p, plan[i], x))
    return Plan(mode="vanilla", model=seg, cut=V_CUT, n_clients=n_clients,
                optimizer=optim.adamw(LR), wire=wire)


def _resnet_payloads(torch) -> list:
    turns, f32 = V_CLIENTS * V_ROUNDS, torch.float32
    return ([("resnet_vanilla_training", "cut_act up / cut_grad down",
              CUT_SHAPE, f32, (2 * turns,) * 2)]
            + [("resnet_vanilla_training", f"handoff {leaf}", shape, f32,
                (k * (turns - 1),) * 2) for leaf, shape, k in R_LEAVES])


def resnet_path(torch) -> dict:
    """ResNet-CIFAR100 at full width (stages (3,4,6,3), widths 64-512, 100
    classes) cut 2 (the stem and the first block on the client), 4
    clients round-robin with the p2p handoff over the physical wire."""
    from repro_torch.api import leakage_probe, quantize_int8
    from repro_torch.configs.resnet50_cifar100 import CONFIG
    from repro_torch.data.synthetic import image_batch
    from repro_torch.engine import tree_at
    from repro_torch.nn.module import param_count

    turns = V_CLIENTS * V_ROUNDS
    print(f"resnet vanilla training path: {CONFIG.name} (stages "
          f"{CONFIG.stages}, widths {CONFIG.widths}, {R_CLASSES} classes, "
          f"fp32) cut at {V_CUT}, {V_CLIENTS} clients round-robin with the "
          f"p2p handoff, batch {VB} per client per turn, {V_ROUNDS} rounds "
          f"({turns} turns), AdamW({LR}), physical int8 wire")
    phys = [quantize_int8(physical=True), leakage_probe()]
    sess = _resnet_plan(CONFIG, phys, V_CLIENTS).compile()
    sess.init(seed=SEED)
    n_client = param_count(tree_at(sess.state["clients"], 0))
    n_server = param_count(sess.state["server"])
    print(f"  client params {n_client} per client; server {n_server}; "
          f"model {n_client + n_server}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    batches = _client_batches(gen, V_ROUNDS + 1, V_CLIENTS, VB, R_CLASSES)
    ev = image_batch(gen, EVAL_B, R_CLASSES)
    ev = {"x": ev["images"], "labels": ev["labels"]}
    report = sess.wire_report(batches[0])
    want = [("cut_act", "up", CUT_SHAPE, V_CUT_BYTES),
            ("cut_grad", "down", CUT_SHAPE, V_CUT_BYTES)]
    got = [(r["name"], r["direction"], r["shape"], r["bytes"])
           for r in report]
    print(f"  wire report: {got}")
    if got != want or not all(r["physical"] for r in report):
        fail(f"resnet wire_report {report}: expected {want}, all physical")
    losses, first_s, round_ms, host_ms, launches, peak_gib = _timed_fit(
        torch, sess, batches, V_ROUNDS)
    print(f"  first round {first_s:.3f} s; then {round_ms:.3f} ms per round "
          f"(CUDA events over rounds 2-{V_ROUNDS}, host {host_ms:.3f} ms), "
          f"{VB * V_CLIENTS / round_ms * 1e3:.1f} examples/s, peak "
          f"{peak_gib:.2f} GiB")
    print(f"  launches over the {V_ROUNDS} rounds: {launches}")
    leaves = sum(k for _, _, k in R_LEAVES)
    k = 2 * turns + leaves * (turns - 1)
    hold_launches(launches, {"wire_quant": k, "wire_dequant": k,
                             **NO_OTHER_KERNEL})
    meter, totals = sess.engine.meter, sess.meter()
    h = [V_ROUNDS - 1] + [V_ROUNDS] * (V_CLIENTS - 1)
    want_gb = [(V_ROUNDS * 2 * V_CUT_BYTES + k * R_HANDOFF_BYTES) / 1e9
               for k in h]
    print(f"  meter: up {meter.bytes_up}, down {meter.bytes_down}, handoff "
          f"{meter.sync_bytes} B ({R_HANDOFF_BYTES} B a handoff); {totals}")
    if (meter.bytes_up != [V_ROUNDS * V_CUT_BYTES] * V_CLIENTS
            or meter.bytes_down != [V_ROUNDS * V_CUT_BYTES] * V_CLIENTS
            or meter.sync_bytes != [k * R_HANDOFF_BYTES for k in h]
            or totals["client_gb"] != want_gb):
        fail(f"resnet meter {totals['client_gb']} GB, expected {want_gb}")
    accs = sess.evaluate_all(ev).tolist()
    print(f"  evaluate_all ({EVAL_B} held-out rows, chance "
          f"{1 / R_CLASSES}): {accs}")
    if len(accs) != V_CLIENTS or min(accs) < 3 / R_CLASSES:
        fail(f"resnet: evaluation accuracies {accs} after {V_ROUNDS} rounds, "
             f"below three times chance ({1 / R_CLASSES})")
    busy_ms = profile_device(torch, f"resnet round ({V_CLIENTS} turns)",
                             lambda: sess.run_round(batches[V_ROUNDS]),
                             round_ms / 1e3, steps=1)
    _physical_equals_fake(torch, lambda w: _resnet_plan(CONFIG, w, V_CLIENTS),
                          phys, sess.state, batches, 3, "resnet vanilla")
    del sess
    torch.cuda.empty_cache()
    return {"launches": launches, "first_round_s": first_s,
            "round_ms": round_ms, "turn_ms": round_ms / V_CLIENTS,
            "busy_ms": busy_ms, "peak_gib": peak_gib,
            "client_params": n_client, "model_params": n_client + n_server,
            "handoff_bytes": R_HANDOFF_BYTES,
            "client_gb": statistics.mean(totals["client_gb"]),
            "first_loss": losses[0], "last_loss": losses[-1],
            "eval_accuracy": accs}


def reduced_resnet_against_cpu(torch):
    """SMOKE ResNet (its second stage opens with a stride-2 block and its
    projection), 3 clients, batch 8, on the card and on the CPU."""
    from repro_torch.api import quantize_int8
    from repro_torch.configs.resnet50_cifar100 import SMOKE

    batches = _client_batches(torch.Generator().manual_seed(4), 3, 3, 8,
                              SMOKE.n_classes, hw=16)
    _reduced_against_cpu(
        torch, "resnet vanilla",
        lambda: _resnet_plan(SMOKE, [quantize_int8(physical=True)], 3),
        batches)


# ---------------------------------------------------------------------------
# phases 3l and 3m: MoE serving (Qwen3-30B-A3B whole, DeepSeek-V2 cut in
# depth)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoERun:
    """One MoE serving path: its name in the records, the layers kept at
    full width (None: all), whether the server takes the fused q8 entry,
    and the reduced model held to the CPU: the prompt at which some
    expert overflows its capacity at prefill (so slots drop) and the
    `reduced()` overrides."""
    path: str
    layers: int | None
    fused: bool
    reduced_prompt: int
    reduced: dict


# DeepSeek-V2's reduced MLA at q/k 32 + 32, v 32: the kernel's (64, 32) pair
MOE_RUNS = {
    "qwen3_moe_30b_a3b": MoERun("qwen3_moe_serving", None, True, 24,
                                dict(vocab=97)),
    "deepseek_v2_236b": MoERun("deepseek_v2_serving", 8, False, 24,
                               dict(vocab=97, qk_rope_head_dim=32))}
# the functions whose device time a profiled step attributes to each span
MOE_SPANS = {"moe": [("repro_torch.nn.moe", "moe_apply")],
             "attention": [("repro_torch.nn.attention", f)
                           for f in ("gqa_decode", "gqa_prefill",
                                     "mla_decode", "mla_prefill")]}


@contextlib.contextmanager
def patched(targets: dict):
    """While open, each (module, function) of `targets` is replaced by
    `targets[...]`'s wrapper of it; the callers look the function up on
    its module, so they reach the wrapper."""
    import importlib

    saved = []
    for (mod_name, fn_name), wrap in targets.items():
        mod = importlib.import_module(mod_name)
        saved.append((mod, fn_name, getattr(mod, fn_name)))
        setattr(mod, fn_name, wrap(getattr(mod, fn_name)))
    try:
        yield
    finally:
        for mod, fn_name, fn in saved:
            setattr(mod, fn_name, fn)


def _in_span(torch, label: str):
    def wrap(fn):
        def spanned(*args, **kw):
            with torch.profiler.record_function(label):
                return fn(*args, **kw)
        return spanned
    return wrap


def moe_path(torch, arch: str) -> dict:
    """A MoE model served split at full width over the physical int8 wire,
    batch 4, prompt 128, 32 generated tokens, bf16 random weights from a
    seeded generator: launches exact, the analytic wire bytes, physical
    == fake tokens bitwise, one profiled decode step and the prefill with
    the device time of the MoE layers and of attention."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.nn.module import param_bytes, param_count
    from repro_torch.serve import ServePlan, ServeSession

    run = MOE_RUNS[arch]
    fused = run.fused
    cfg = get_config(arch)
    if run.layers:
        cfg = dataclasses.replace(cfg, n_layers=run.layers)
    model = build_model(cfg)
    mixer = model.groups[-1].specs[0].mixer
    attn = (f"MLA (q LoRA {cfg.q_lora_rank}, kv LoRA {cfg.kv_lora_rank}, "
            f"{cfg.n_heads} heads of {cfg.qk_nope_head_dim} + "
            f"{cfg.qk_rope_head_dim} / v {cfg.v_head_dim})"
            if mixer == "mla" else
            f"GQA {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}")
    groups = [(g.n_repeat, g.specs[0].mixer, g.specs[0].mlp)
              for g in model.groups]
    print(f"MoE serving path: {cfg.name} {cfg.n_layers} layers {groups}, "
          f"d_model {cfg.d_model}, {attn}, {cfg.n_experts} experts of "
          f"{cfg.d_ff} top-{cfg.top_k}"
          + (f" + {cfg.n_shared} shared" if cfg.n_shared else "")
          + (f", first {cfg.first_dense} dense (SwiGLU {cfg.dense_d_ff})"
             if cfg.first_dense else "")
          + f", vocab {cfg.vocab}, {cfg.dtype}, cut {cfg.default_cut}, "
          f"batch {B}, prompt {PROMPT}, generate {GEN}, fused entry {fused}")
    gc.collect()                 # the earlier phases' models are gone
    torch.cuda.empty_cache()
    print(f"  before init: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          "allocated")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(gen, "cuda")
    torch.cuda.synchronize()
    n_params = param_count(params)
    init_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  init on the card: {time.perf_counter() - t0:.2f} s, "
          f"{n_params} parameters, {param_bytes(params) / 1e9:.3f} GB, "
          f"init's peak {init_peak_gib:.2f} GiB")
    gen.manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                            device="cuda")

    def session(wire, fused_entry=False):
        return ServeSession(ServePlan(arch=cfg, wire=wire, max_batch=B,
                                      max_len=PROMPT + GEN + 1,
                                      fused_entry=fused_entry), params,
                            device="cuda")

    serve = session("quantize_int8:physical", fused)
    serve.generate(prompts, 2)                   # warmup
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()         # the serving peak from here

    ops.reset_launches()
    t0 = time.perf_counter()
    tok0 = serve.prefill(prompts)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    rest = serve.decode(tok0, GEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    toks = torch.cat([tok0, rest], dim=1)
    print(f"  prefill {t_prefill:.4f} s; decode {GEN - 1} steps "
          f"{t_decode:.4f} s = {B * (GEN - 1) / t_decode:.1f} tok/s; "
          f"serving peak {peak_gib:.2f} GiB")
    print(f"  launches on the path: {launches}")
    # rmsnorm: every block's two norms (MLA adds q_norm and kv_norm) and
    # the final norm, at prefill and at every decode step, less the
    # server's first norm at decode when the fused entry folds it into
    # the payload's scales; flash_attention: one per layer at prefill,
    # none at decode; the wire kernels once per hop each way; the q8
    # entry once per decode step when fused
    per_forward = (4 if mixer == "mla" else 2) * cfg.n_layers + 1
    want = {"rmsnorm": per_forward * GEN - (GEN - 1) * int(fused),
            "rmsnorm_bwd": 0, "flash_attention": cfg.n_layers,
            "wire_quant": 2 * GEN, "wire_dequant": 2 * GEN,
            "splitcat_linear_q8": (GEN - 1) * int(fused),
            "splitcat_linear": 0, "ssd_scan": 0}
    hold_launches(launches, want)

    tok = rest[:, -1:]

    def step():
        nonlocal tok
        tok = serve.decode_step(tok)
    spans = {(m, f): _in_span(torch, label)
             for label, fns in MOE_SPANS.items() for m, f in fns}
    step_spans = dict.fromkeys(MOE_SPANS, 0.0)
    prefill_spans = dict.fromkeys(MOE_SPANS, 0.0)
    with patched(spans):
        busy_ms = profile_device(torch, f"{cfg.name} decode step", step,
                                 t_decode / (GEN - 1), steps=2,
                                 span_ms=step_spans)
        prefill_busy_ms = profile_device(
            torch, f"{cfg.name} prefill", lambda: serve.prefill(prompts),
            t_prefill, steps=1, span_ms=prefill_spans)
    # a caller that goes around the wrapped names leaves its span at 0
    for when, got in (("decode step", step_spans),
                      ("prefill", prefill_spans)):
        for label, ms in got.items():
            if not ms > 0:
                fail(f"{cfg.name} {when}: no device time inside `{label}` "
                     f"({MOE_SPANS[label]})")
    if tuple(toks.shape) != (B, GEN):
        fail(f"generated shape {tuple(toks.shape)} != {(B, GEN)}")
    if not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        fail("generated tokens outside the vocabulary")

    per_tok = serve.bytes_per_token()
    cost = serve.decode_cost(batch=B)
    dense = session("").bytes_per_token()
    print(f"  wire bytes per generated token per row: {per_tok} (up "
          f"{cost.bytes_up // B}, down {cost.bytes_down // B}); bf16 wire "
          f"{dense}")
    # d_model + 4 up, vocab + 4 down (int8 rows and their fp32 scales)
    wire_bytes = (cfg.d_model + 4) + (cfg.vocab + 4)
    if per_tok != wire_bytes or cost.bytes_up + cost.bytes_down != (
            B * per_tok):
        fail(f"{cfg.name}: wire bytes per token {per_tok} != {wire_bytes}")
    if dense != cfg.dtype.itemsize * (cfg.d_model + cfg.vocab):
        fail(f"{cfg.name}: bf16 wire bytes per token {dense}")
    if not fused:
        try:
            session("quantize_int8:physical", True)
        except ValueError as e:
            print(f"  fused_entry=True refused, as in the reference: {e}")
        else:
            fail(f"{cfg.name}: fused_entry=True accepted at an {mixer} "
                 "server entry")

    phys = session("quantize_int8:physical").generate(prompts, GEN)
    fake = session("quantize_int8").generate(prompts, GEN)
    if not torch.equal(phys, fake):
        fail(f"{cfg.name}: physical-wire tokens differ from fake-wire "
             f"tokens:\n{phys.tolist()}\n{fake.tolist()}")
    print(f"  physical wire == fake wire tokens: bitwise ({B}x{GEN}); "
          f"{int((phys == toks).sum())}/{B * GEN} shared with the timed run")
    del serve, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "params": n_params,
            "prefill_s": t_prefill, "prefill_busy_ms": prefill_busy_ms,
            "prefill_span_ms": prefill_spans,
            "decode_tok_per_s": B * (GEN - 1) / t_decode,
            "decode_step_ms": t_decode / (GEN - 1) * 1e3,
            "busy_ms": busy_ms, "decode_span_ms": step_spans,
            "peak_gib": peak_gib, "init_peak_gib": init_peak_gib,
            "wire_bytes_per_token": per_tok}


def reduced_moe_against_cpu(torch, arch: str, device: str = "cuda"):
    """A reduced fp32 model served on the card (kernels) and on the CPU
    (plain versions) from the same weights over the physical wire (Qwen3
    through the fused entry) must generate the same tokens, at a prompt
    where some expert overflows its capacity at prefill.  The served runs
    are the plain `generate`; the CPU run also keeps each prefill MoE
    layer's input, and a probe calls `moe_apply(..., return_aux=True)` on
    it on the CPU and on the card: the drop fractions are printed, and
    one on each must be above 0."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.nn.module import tree_map
    from repro_torch.nn.moe import moe_apply
    from repro_torch.serve import ServePlan, ServeSession

    run = MOE_RUNS[arch]
    s = run.reduced_prompt
    cfg = get_config(arch).reduced(**run.reduced)
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg).init(gen, "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, s), generator=gen)
    plan = ServePlan(arch=cfg, wire="quantize_int8:physical", max_batch=2,
                     max_len=s + 8, fused_entry=run.fused)
    inputs = []

    def keep(fn):
        def kept(p, mcfg, x, **kw):
            if x.shape[1] > 1:                  # a prefill
                inputs.append((p, mcfg, x))
            return fn(p, mcfg, x, **kw)
        return kept
    with patched({("repro_torch.nn.moe", "moe_apply"): keep}):
        on_cpu = ServeSession(plan, params, device="cpu").generate(prompts, 6)
    ops.reset_launches()
    on_card = ServeSession(plan, params, device=device).generate(prompts, 6)
    n_flash = ops.launch_counts()["flash_attention"]
    if device == "cuda" and n_flash != cfg.n_layers:
        fail(f"reduced {cfg.name}: {n_flash} flash_attention launches, "
             f"expected {cfg.n_layers} (one per layer at prefill)")
    if not torch.equal(on_cpu, on_card.cpu()):
        fail(f"reduced {cfg.name}: card tokens {on_card.tolist()} != CPU "
             f"tokens {on_cpu.tolist()}")
    drops = {}
    for where in ("cpu", device):
        drops[where] = [float(moe_apply(
            tree_map(lambda t: t.to(where), p), mcfg, x.to(where),
            return_aux=True)[1]["drop_fraction"]) for p, mcfg, x in inputs]
        if not drops[where] or max(drops[where]) <= 0:
            fail(f"reduced {cfg.name}: no expert overflowed at prompt {s} "
                 f"on {where} ({drops[where]})")
    dqk = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
           if cfg.attn_kind == "mla" else cfg.resolved_head_dim)
    print(f"reduced {cfg.name} (flash at q/k {dqk}), prompt {s}, prefill "
          f"drop_fraction by MoE layer (moe_apply on its served input): "
          f"CPU {drops['cpu']}, card {drops[device]}; card == CPU plain "
          f"path: {on_cpu.tolist()}")


# ---------------------------------------------------------------------------
# phase 3n: monolithic serving (the serve CLI's default mode)
# ---------------------------------------------------------------------------

MONO_PATH = "{}_monolithic_serving"
# the dense configs served whole, each cut in depth only where its bf16
# weights would not leave MONO_FREE_GIB of the card free
MONO_ARCHS = ("chatglm3_6b", "qwen1_5_32b", "mistral_large_123b")
MONO_FREE_GIB = 8
MONO_RESERVE_GIB = 2        # caches, activations, logits, init's fp32 leaf


def _serve_cli(torch, argv, cfg=None):
    """`repro_torch.launch.serve.main(argv)` with its stdout captured and
    echoed: (the run, its JSON summary parsed from the last line)."""
    import io

    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = serve.main(argv, cfg=cfg)
    lines = buf.getvalue().strip().splitlines()
    for line in lines[:-1]:
        print(f"  | {line}")
    try:
        summary = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"serve CLI {argv}: the last line is not a JSON object: "
             f"{lines[-1:]}")
    return run, summary


def _mono_launches(cfg, runs: int = 2) -> dict:
    """A monolithic CLI run's launches: its warmup and its timed run, each
    one prefill and GEN - 1 decode steps, every forward 2 norms a layer
    and the final norm; flash once a layer at prefill; no wire kernel."""
    return {"rmsnorm": runs * GEN * (2 * cfg.n_layers + 1),
            "rmsnorm_bwd": 0, "flash_attention": runs * cfg.n_layers,
            "wire_quant": 0, "wire_dequant": 0, "splitcat_linear_q8": 0,
            "splitcat_linear": 0, "ssd_scan": 0}


def _mono_depth(torch, cfg):
    """The deepest N of `cfg`'s layers whose bf16 weights, with
    MONO_RESERVE_GIB for the rest of serving, leave MONO_FREE_GIB of the
    card free; from the bytes of the model on meta tensors."""
    from repro_torch.models import build_model
    from repro_torch.nn.module import param_bytes

    def size(n):
        m = build_model(dataclasses.replace(cfg, n_layers=n))
        return param_bytes(m.init(torch.Generator(), "meta"))
    layer = size(2) - size(1)
    base = size(1) - layer
    total = torch.cuda.get_device_properties(0).total_memory
    room = total - (MONO_FREE_GIB + MONO_RESERVE_GIB) * 2 ** 30 - base
    return min(cfg.n_layers, int(room // layer)), layer, base


def mono_run(torch, arch: str, cfg=None) -> dict:
    """One monolithic CLI run at batch B, prompt PROMPT, GEN tokens, bf16
    random weights from the CLI's seed: launches exact, the timings, the
    peak, a profiled decode step.  Returns the result with the run."""
    from repro_torch.kernels import ops

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", arch, "--batch", str(B), "--prompt-len", str(PROMPT),
            "--gen", str(GEN)]
    ops.reset_launches()
    run, summary = _serve_cli(torch, argv, cfg)
    launches = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    reserved_gib = torch.cuda.max_memory_reserved() / 2 ** 30
    cfg = cfg or _config(arch)
    hold_launches(launches, _mono_launches(cfg))
    toks = run.tokens
    if tuple(toks.shape) != (B, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        fail(f"{cfg.name} monolithic: tokens {tuple(toks.shape)} outside "
             f"({B}, {GEN}) x [0, {cfg.vocab})")
    want = {"arch", "batch", "prompt_len", "generated", "device", "mode",
            "prefill_s", "decode_s", "decode_tok_per_s", "sample_tokens"}
    if set(summary) != want or summary["device"] != \
            torch.cuda.get_device_name(0):
        fail(f"{cfg.name} monolithic: summary keys {sorted(summary)}")
    step_ms = summary["decode_s"] / (GEN - 1) * 1e3
    tok = toks[:, -1:]

    def step():
        nonlocal tok
        tok = run.step(tok)
    busy_ms = profile_device(torch, f"{cfg.name} monolithic decode step",
                             step, step_ms / 1e3, steps=4)
    print(f"  {cfg.name} monolithic ({summary['mode']}): prefill "
          f"{summary['prefill_s']:.4f} s, decode {step_ms:.3f} ms a step = "
          f"{summary['decode_tok_per_s']:.1f} tok/s, peak {peak_gib:.2f} GiB "
          f"allocated ({reserved_gib:.2f} GiB reserved); launches "
          f"{launches}")
    return {"launches": launches, "layers": cfg.n_layers,
            "prefill_s": summary["prefill_s"], "decode_step_ms": step_ms,
            "decode_tok_per_s": summary["decode_tok_per_s"],
            "busy_ms": busy_ms, "peak_gib": peak_gib,
            "reserved_gib": reserved_gib, "run": run}


def _config(arch):
    from repro_torch.configs import get_config
    return get_config(arch)


def mono_path(torch) -> dict:
    """phi4-mini whole through the serve CLI's default (monolithic) mode:
    launches exact, its tokens bitwise those of a `ServeSession` over the
    dense wire at cut 4 (nothing quantizes, so the cut is invisible).
    Then ChatGLM3-6B and the reference's scaled qwen1_5_32b whole and
    Mistral-Large-123B cut in depth the same way."""
    from repro_torch.serve import ServePlan, ServeSession

    out = {}
    phi = mono_run(torch, "phi4_mini_3_8b")
    scan = phi.pop("run").tokens
    out[MONO_PATH.format("phi4_mini")] = phi
    cfg = _config("phi4_mini_3_8b")
    gen = torch.Generator(device="cuda").manual_seed(1)   # the CLI's prompt
    prompts = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                            device="cuda")
    sess = ServeSession(ServePlan(arch=cfg, cut=CUT, wire="", max_batch=B,
                                  max_len=PROMPT + GEN + 1), 0,
                        device="cuda")
    split = sess.generate(prompts, GEN)
    del sess
    if not torch.equal(split, scan):
        fail(f"monolithic tokens {scan.tolist()} != split dense-wire tokens "
             f"{split.tolist()} at cut {CUT}")
    print(f"  phi4-mini monolithic tokens == split (cut {CUT}, dense wire) "
          f"tokens, bitwise ({B}x{GEN})")
    for arch in MONO_ARCHS:
        cfg = _config(arch)
        n, layer, base = _mono_depth(torch, cfg)
        print(f"  {cfg.name}: {layer / 1e9:.3f} GB a layer, {base / 1e9:.3f} "
              f"GB outside the layers; the deepest depth that leaves "
              f"{MONO_FREE_GIB} GiB free is {n} of its {cfg.n_layers} layers")
        if n < cfg.n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n)
        print(f"monolithic serving: {cfg.name} {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
              f"{cfg.resolved_head_dim}, SwiGLU {cfg.d_ff}, vocab "
              f"{cfg.vocab}, qkv_bias {cfg.qkv_bias}, rope_fraction "
              f"{cfg.rope_fraction}, "
              f"rope_theta {cfg.rope_theta:g}, {cfg.dtype}")
        res = mono_run(torch, arch, cfg=cfg)
        del res["run"]
        total_gib = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
        if total_gib - res["peak_gib"] < MONO_FREE_GIB:
            fail(f"{cfg.name} at {cfg.n_layers} layers: peak "
                 f"{res['peak_gib']:.2f} GiB leaves less than "
                 f"{MONO_FREE_GIB} GiB of {total_gib:.2f} free")
        out[MONO_PATH.format(arch)] = res
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3o: continuous batching (the Batcher, per-row cache cursors)
# ---------------------------------------------------------------------------

BAT_PATH = "batcher_serving"
# phi4-mini at full width cut to 8 of its 32 layers (the client's 4 and 4
# server layers): a step's host time and the solo streams' grow with the
# depth, and the whole run must stay inside its time limit
BAT_LAYERS = 8
BAT_SLOTS, BAT_TENANTS = 8, 12
BAT_PROMPTS, BAT_NEW = (16, 256), (8, 48)
BAT_MAX_LEN = BAT_PROMPTS[1] + BAT_NEW[1] + 1
# a batched row's largest logit difference from its solo B=1 row, as a
# share of the solo top logit: 3x the 0.0168 read on the H100 80GB HBM3
# (700 W) while the streams agreed; a wrong server step differs by O(1)
BAT_SOLO_REL = 0.05
# the reduced card == CPU runs: (arch, reduced() overrides, fused entry)
BAT_REDUCED = [("phi4_mini_3_8b", dict(vocab=97), True),
               ("mamba2_130m", dict(vocab=97), False),
               ("recurrentgemma_2b", dict(vocab=97, n_layers=6, window=8),
                False),
               ("deepseek_v2_236b", dict(vocab=97, qk_rope_head_dim=32),
                False)]


def bat_tenants(n=BAT_TENANTS, prompts=BAT_PROMPTS, new=BAT_NEW,
                seed=SEED) -> list:
    """The queue: (prompt length, max_new) per tenant, seeded."""
    import random

    rng = random.Random(seed)
    return [(rng.randint(*prompts), rng.randint(*new)) for _ in range(n)]


def bat_schedule(tenants: list, slots: int) -> list:
    """The live tenants at each step of `run_queue` (no EOS): seat while a
    slot is free, step, free the slots whose budget is spent."""
    left = [n for _, n in tenants]          # tokens still to make
    queue, live, steps = list(range(len(tenants))), [], []
    while queue or live:
        while queue and len(live) < slots:
            t = queue.pop(0)
            left[t] -= 1                      # the prefill's token
            if left[t]:
                live.append(t)
        if not live:
            continue
        steps.append(len(live))
        for t in live:
            left[t] -= 1
        live = [t for t in live if left[t]]
    return steps


def bat_payloads(torch) -> list:
    """The Batcher's wire payloads a counted run, (quantize, dequantize)
    launches each: every join's prefill activation and last logits; a
    step's B=1 client rows up (one quantize each, plus the pad row's once
    a run), the stacked (slots, 1, d) payload dequantized once for the
    residual (the q8 entry reads its int8 rows), and the stacked logits
    both ways."""
    cfg = _config("phi4_mini_3_8b")
    tenants = bat_tenants()
    steps = bat_schedule(tenants, BAT_SLOTS)
    d, v, bf16 = cfg.d_model, cfg.vocab, cfg.dtype
    out = [(BAT_PATH, f"join up (prompt {s})", (1, s, d), bf16, (1, 1))
           for s, _ in tenants]
    return out + [
        (BAT_PATH, "join down (logits)", (1, 1, v), bf16,
         (len(tenants), len(tenants))),
        (BAT_PATH, "step up (a tenant's row, the pad row once)", (1, 1, d),
         bf16, (sum(steps) + 1, 0)),
        (BAT_PATH, "step stacked up (residual)", (BAT_SLOTS, 1, d), bf16,
         (0, len(steps))),
        (BAT_PATH, "step down (stacked logits)", (BAT_SLOTS, 1, v), bf16,
         (len(steps), len(steps)))]


def run_queue(torch, batcher, prompts: list, budgets: list, after=None,
              extras=None):
    """Seat the queue's tenants in order while a slot is free, step, and
    repeat until all have finished; `after(live)` runs after each step
    with the slots that were live in it; `extras`, one per tenant, are
    its modality inputs.  Returns (the Tenant objects in queue order, the
    live count of each step)."""
    tenants, steps = [], []
    queue = list(zip(prompts, budgets, extras or [None] * len(prompts)))
    while queue or batcher.tenants:
        while queue and batcher.free_slots():
            prompt, budget, extra = queue.pop(0)
            slot = batcher.join(prompt, budget, extra)
            tenants.append(batcher.tenants.get(slot) or batcher.finished[-1])
        live = sorted(batcher.tenants)
        if not live:
            continue
        batcher.step()
        steps.append(len(live))
        if after is not None:
            after(live)
    return tenants, steps


def _bat_prompts(torch, tenants, vocab, device="cuda", seed=SEED + 2):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randint(0, vocab, (s,), generator=gen, device=device)
            for s, _ in tenants]


def _bat_want_launches(tenants, steps, cfg, cut) -> dict:
    """Per join: the B=1 prefill (2 norms a layer and the final norm,
    flash once a layer), its activation and last logits once each way.
    Per step: each live tenant's client rows (2 norms a client layer, one
    quantize), then the server at the fused entry (its first norm folded
    into the scales, the final norm), the q8 entry once, the stacked
    payload's dequantize for the residual, the logits both ways; the pad
    row's quantize once a run."""
    n, live = len(tenants), sum(steps)
    server = cfg.n_layers - cut
    return {"rmsnorm": n * (2 * cfg.n_layers + 1) + live * 2 * cut
            + len(steps) * (2 * server - 1 + 1),
            "rmsnorm_bwd": 0, "flash_attention": n * cfg.n_layers,
            "wire_quant": 2 * n + live + len(steps) + 1,
            "wire_dequant": 2 * n + 2 * len(steps),
            "splitcat_linear_q8": len(steps), "splitcat_linear": 0,
            "ssd_scan": 0}


def batcher_path(torch) -> dict:
    """phi4-mini whole split at 4 over the physical int8 wire through the
    fused entry, a `Batcher` of 8 slots serving a queue of 12 tenants
    (prompts 16-256, 8-48 tokens, seeded): bytes and launches exact, row
    independence bitwise, each tenant's logits at every step (its solo
    tokens forced as inputs) within BAT_SOLO_REL of its solo B=1
    stream's."""
    from repro_torch.core.wire_compress import PackedInt8
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import Batcher, ServePlan, ServeSession

    cfg = dataclasses.replace(_config("phi4_mini_3_8b"), n_layers=BAT_LAYERS)
    tenants = bat_tenants()
    budgets = [n for _, n in tenants]
    print(f"continuous batching: {cfg.name} {cfg.n_layers} layers, cut {CUT}, "
          f"physical int8 wire, fused entry, {BAT_SLOTS} slots, "
          f"{BAT_TENANTS} tenants (prompt, max_new) {tenants}")
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = build_model(cfg).init(gen, "cuda")
    prompts = _bat_prompts(torch, tenants, cfg.vocab)

    def session(slots=BAT_SLOTS):
        return ServeSession(ServePlan(arch=cfg, cut=CUT,
                                      wire="quantize_int8:physical",
                                      max_batch=slots, max_len=BAT_MAX_LEN,
                                      fused_entry=True), params,
                            device="cuda")
    sess = session()
    warm = Batcher(sess)                          # warmup (kernel build)
    run_queue(torch, warm, prompts[:2], [2, 2])
    torch.cuda.synchronize()
    del warm

    # the counted, timed run
    bat = Batcher(sess)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, steps = run_queue(torch, bat, prompts, budgets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print(f"  {len(steps)} steps, live tenants a step {steps}")
    if steps != bat_schedule(tenants, BAT_SLOTS):
        fail(f"batcher steps {steps} != the schedule "
             f"{bat_schedule(tenants, BAT_SLOTS)}")
    hold_launches(launches, _bat_want_launches(tenants, steps, cfg, CUT))
    print(f"  launches exact: {launches}")
    lens = [len(t.tokens) for t in done]
    if lens != budgets:
        fail(f"batcher token counts {lens} != max_new {budgets}")
    up_row, down_row = cfg.d_model + 4, cfg.vocab + 4
    want_bytes = sum(s * up_row + down_row + (n - 1) * (up_row + down_row)
                     for s, n in tenants)
    if bat.bytes_up + bat.bytes_down != want_bytes or \
            bat.tokens_generated != sum(budgets):
        fail(f"batcher bytes {bat.bytes_up} + {bat.bytes_down} != "
             f"{want_bytes} or tokens {bat.tokens_generated} != "
             f"{sum(budgets)}")
    tok_s = bat.tokens_generated / wall
    print(f"  bytes exact: up {bat.bytes_up} + down {bat.bytes_down} = "
          f"{want_bytes}, {bat.tokens_generated} tokens, "
          f"{bat.bytes_per_token:.1f} B a token; {wall:.3f} s wall = "
          f"{tok_s:.1f} tok/s (joins included)")

    # each tenant's solo B=1 stream, and the fp32 logits behind each of
    # its tokens (before the down wire)
    solo_sess = session(1)
    solo, solo_logits, kept = [], [], []

    def keep(fn):
        def kept_record(wires, name, t, direction):
            if name in ("prefill_logits", "logits"):
                kept.append(t[0, -1].float())
            return fn(wires, name, t, direction)
        return kept_record
    with patched({("repro_torch.serve.split_infer", "record"): keep}):
        for prompt, n in zip(prompts, budgets):
            kept.clear()
            solo.append(solo_sess.generate(prompt[None], n)[0].tolist())
            solo_logits.append(kept[:n])
    del solo_sess
    for s, t in zip(solo, done):
        if s[0] != t.tokens[0]:
            fail(f"tenant in slot {t.slot}: first token {t.tokens[0]} != "
                 f"solo {s[0]} (both prefills run at B=1)")

    # row independence and the solo check, on one pair of runs: the queue
    # twice in lockstep, run b with random packed pad rows, each live
    # tenant's next input forced to its solo token in both, so every step
    # of every tenant reads its solo stream's inputs.  After every step
    # every token and every live cache row is bitwise the same in a and b
    a, b = Batcher(sess), Batcher(sess)
    rnd = torch.Generator(device="cuda").manual_seed(SEED + 3)
    b._pad_part = PackedInt8(
        torch.randint(-127, 128, (1, 1, cfg.d_model), generator=rnd,
                      device="cuda", dtype=torch.int8),
        torch.rand((1, 1, 1), generator=rnd, device="cuda") + 0.01,
        cfg.dtype)
    n_rows = [0]

    def same_rows(live):
        idx = torch.tensor(live, device="cuda")
        for ga, gb in zip(a._sc, b._sc):
            for la, lb in zip(ga, gb):
                for i, leaves in la.items():
                    for k, va in leaves.items():
                        if not torch.equal(va[idx], lb[i][k][idx]):
                            fail(f"row independence: cache leaf {k} of "
                                 f"live slots {live} differs with random "
                                 "pad rows")
        n_rows[0] += len(live)
    # run a's logits as its slots receive them, before the down wire, and
    # its tokens, by queue index
    stack_apply, capture = sess.stack.apply, [None]
    forced = [[] for _ in tenants]
    picks = [[] for _ in tenants]

    def apply(t, name, direction):
        if name == "logits" and capture[0] is not None:
            for slot, k in capture[0].items():
                forced[k].append(t[slot, -1].float())
        return stack_apply(t, name, direction)
    sess.stack.apply = apply
    queue_a, queue_b = list(range(len(tenants))), list(range(len(tenants)))
    seat = {}
    while queue_a or a.tenants:
        while queue_a and a.free_slots():
            k = queue_a.pop(0)
            seat[a.join(prompts[k], budgets[k])] = k
        while queue_b and b.free_slots():
            k = queue_b.pop(0)
            if seat.get(b.join(prompts[k], budgets[k])) != k:
                fail("row independence: the two runs seat different slots")
        live = sorted(a.tenants)
        if sorted(b.tenants) != live:
            fail("row independence: the two runs seat different slots")
        capture[0] = {slot: seat[slot] for slot in live}
        out_a = a.step()
        capture[0] = None
        out_b = b.step()
        if out_a != out_b:
            fail(f"row independence: tokens {out_a} != {out_b} with random "
                 "pad rows")
        same_rows(live)
        for slot in live:
            k = seat[slot]
            picks[k].append(out_a[slot])
            if slot in a.tenants:            # not finished: force its input
                tok = solo[k][len(picks[k])]
                cur = torch.tensor([[tok]], device="cuda")
                for bt in (a, b):
                    bt.tenants[slot].tokens[-1] = tok
                    bt.tenants[slot].cur = cur
    if [len(p) + 1 for p in picks] != budgets:
        fail(f"forced run token counts {[len(p) + 1 for p in picks]} != "
             f"max_new {budgets}")
    print(f"  row independence: random pad rows leave every live token and "
          f"every live cache row ({n_rows[0]} slot-steps, all "
          f"{cfg.n_layers - CUT} server layers) bitwise the same")
    del sess.stack.apply
    del a, b

    # run a against the solo streams.  Their inputs are equal at every
    # step; only the server's GEMMs differ (M = 8 rows against M = 1), so
    # a row's logits must be within BAT_SOLO_REL of the solo top logit,
    # and its token the solo one wherever the solo argmax, lowered by its
    # difference, clears every other logit, raised by its own, by more
    # than one int8 level of the down wire
    rel, held, equal = [], 0, 0
    for k, n in enumerate(budgets):
        for i in range(1, n):
            want, got = solo_logits[k][i], forced[k][i - 1]
            d = (got - want).abs()
            j = int(torch.argmax(want))
            rel.append(d.max().item() / abs(want[j].item()))
            if rel[-1] > BAT_SOLO_REL:
                fail(f"tenant {k}, token {i}: the batched logits differ "
                     f"from the solo ones by {rel[-1]:.4g} of the top "
                     f"logit, above {BAT_SOLO_REL}")
            rival = want + d
            rival[j] = -math.inf
            gap = (want[j] - d[j] - rival.max()).item()
            level = max(want.abs().max().item(),
                        got.abs().max().item()) / 127
            if gap > level:
                held += 1
                if picks[k][i - 1] != solo[k][i]:
                    fail(f"tenant {k}: token {i} {picks[k][i - 1]} != solo "
                         f"{solo[k][i]}, though the solo argmax clears "
                         f"every other logit by {gap:.4g} after the runs' "
                         f"differences, more than an int8 level "
                         f"({level:.4g})")
            equal += picks[k][i - 1] == solo[k][i]
    # the counted run: while a tenant's tokens so far are its solo ones,
    # its inputs are run a's (and rows are independent), so its next
    # token is run a's, bitwise
    matched, total, prefix = 0, 0, 0
    for k, t in enumerate(done):
        for i in range(1, budgets[k]):
            if t.tokens[:i] != solo[k][:i]:
                break
            prefix += 1
            if t.tokens[i] != picks[k][i - 1]:
                fail(f"tenant {k}: the counted run's token {i} "
                     f"{t.tokens[i]} != the forced run's "
                     f"{picks[k][i - 1]} on the same inputs")
        matched += sum(x == y for x, y in zip(solo[k], t.tokens))
        total += budgets[k]
    print(f"  against each tenant's solo B=1 stream: first tokens equal; "
          f"with the solo inputs forced, a row's logits within "
          f"{max(rel):.4g} of the solo top logit at most (limit "
          f"{BAT_SOLO_REL}, median {statistics.median(rel):.4g}, "
          f"{len(rel)} tokens), {equal}/{len(rel)} tokens the solo ones, "
          f"all {held} whose solo argmax clears the difference and an int8 "
          f"level; the counted run == the forced run on its {prefix} "
          f"steps with solo inputs; {matched}/{total} = "
          f"{matched / total:.3f} of the counted run's tokens equal to solo")

    # a full step's busy share: all slots live
    prof = Batcher(sess)
    for prompt in prompts[:BAT_SLOTS]:
        prof.join(prompt, 64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(6):
        prof.step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 6
    busy_ms = profile_device(torch, f"batcher step ({BAT_SLOTS} live)",
                             prof.step, step_s, steps=4)
    del prof, sess, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "steps": len(steps), "wall_s": wall,
            "tok_per_s": tok_s, "full_step_ms": step_s * 1e3,
            "busy_ms": busy_ms, "bytes": want_bytes,
            "tokens": bat.tokens_generated,
            "solo_match_fraction": matched / total,
            "solo_logit_diff_max": max(rel), "solo_rel_limit": BAT_SOLO_REL}


def reduced_batcher_against_cpu(torch):
    """Reduced fp32 models under one join schedule (7 tenants, 3 slots,
    prompts 5-19, 3-8 tokens, seeded) served by the `Batcher` on the card
    and on the CPU from the same weights over the physical wire: the same
    streams token for token (phi4-mini through the fused entry, Mamba2,
    RecurrentGemma with an 8-row window that wraps per row, DeepSeek-V2's
    MLA per row at the flash kernel's (64, 32) pair)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Batcher, ServePlan, ServeSession

    tenants = bat_tenants(7, (5, 19), (3, 8), seed=SEED + 4)
    budgets = [n for _, n in tenants]
    for arch, red, fused in BAT_REDUCED:
        cfg = get_config(arch).reduced(**red)
        params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                       "cpu")
        prompts = _bat_prompts(torch, tenants, cfg.vocab, "cpu")
        plan = ServePlan(arch=cfg, wire="quantize_int8:physical",
                         max_batch=3, max_len=30, fused_entry=fused)
        streams = {}
        for device in ("cpu", "cuda"):
            bat = Batcher(ServeSession(plan, params, device=device))
            done, _ = run_queue(torch, bat, [p.to(device) for p in prompts],
                                budgets)
            streams[device] = [t.tokens for t in done]
        if streams["cpu"] != streams["cuda"]:
            fail(f"reduced {cfg.name} batcher: card streams "
                 f"{streams['cuda']} != CPU streams {streams['cpu']}")
        print(f"reduced {cfg.name} batcher, card == CPU plain path: "
              f"{streams['cpu']}")


# ---------------------------------------------------------------------------
# phase 3p: the paper's Tables 1-2 and Fig. 3, and the four examples
# ---------------------------------------------------------------------------

FIG3_PATH = "paper_fig3"
FIG3_METHODS = ("splitnn", "federated", "large_batch")
# the least final held-out accuracy each Fig. 3 method must reach after
# 30 rounds, set below the least of seven card runs (`chip_spread.py
# fig3` and this phase; each run's readings in PERF.md section 6):
# splitNN read 0.9961-1.0, federated 0.5391-1.0, large_batch
# 0.7969-0.9883; federated's floor is 3x chance
FIG3_MIN_ACC = {"splitnn": 0.9, "federated": 0.3, "large_batch": 0.5}
EXAMPLE_NAMES = ("quickstart", "multihop_tor", "multimodal_vertical",
                 "e2e_train_100m")


def _example(name: str):
    """`examples/torch_<name>.py` as a module, its `main` not yet run."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _no_launches() -> dict:
    from repro_torch.kernels import ops

    return {k: 0 for k in ops.launch_counts()}


def _lm_turn_launches(cfg, cut: int, steps: int) -> dict:
    """rmsnorm, rmsnorm_bwd and flash_attention over `steps` vanilla turns
    of one client over a dense LM: the client's forward (`cut` blocks,
    two norms each) and the server's (the other blocks and the final
    norm), both differentiated (RMS_BWD_KERNELS backward kernels an
    rmsnorm), one flash prefill a block; the fake int8 wire launches
    nothing."""
    norms = steps * (2 * cut + 2 * (cfg.n_layers - cut) + 1)
    return {**_no_launches(), "rmsnorm": norms,
            "rmsnorm_bwd": RMS_BWD_KERNELS * norms,
            "flash_attention": steps * cfg.n_layers}


def paper_tables_path(torch) -> dict:
    """`paper_tables.main(["--full"])`: Tables 1-2 as `table{1,2}_rows`
    give them, and Fig. 3 over the paper's VGG-16 (10 classes, 4 clients
    of 128 rows, AdamW 1e-4, 30 rounds): each method's cumulative client TFLOPs rising, equal to 3 x
    the forward's analytic FLOPs a row (`vgg16_flops_per_sample`: cut 2
    for splitNN, the whole net for the baselines) times the rows seen,
    splitNN's below both baselines' at every point and fedavg's equal to
    large_batch's (one local step); every method's final held-out
    accuracy at least `FIG3_MIN_ACC`'s.  No kernel runs here."""
    from repro_torch.core.accounting import vgg16_flops_per_sample
    from repro_torch.kernels import ops
    from repro_torch.launch import paper_tables as pt

    ops.reset_launches()
    t0 = time.perf_counter()
    out = pt.main(["--full"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    hold_launches(launches, _no_launches())

    # the rows themselves are host arithmetic, held to the reference's at
    # 1e-12 by tests/test_torch_protocol.py on the CPU
    for table, rows_fn, key in (("table1", pt.table1_rows, "tflops"),
                                ("table2", pt.table2_rows, "gb")):
        if out[table] != rows_fn():
            fail(f"{table}: paper_tables.main printed {out[table]}, "
                 f"not {rows_fn.__name__}() {rows_fn()}")
        print(f"{table} ({key} a client): " + ", ".join(
            f"{m} n={n} {v:.6g}" for m, n, v in out[table]))

    cfg, rows = pt.FULL["cfg"], pt.FULL["rows"]
    curve = {m: [(t, a) for mm, t, a in out["fig3"] if mm == m]
             for m in FIG3_METHODS}
    every = pt.EVAL_EVERY
    points = V_ROUNDS // every
    per_row = {"splitnn": vgg16_flops_per_sample(upto_layer=V_CUT),
               "federated": vgg16_flops_per_sample(),
               "large_batch": vgg16_flops_per_sample()}
    if [m for m, _, _ in out["fig3"]] != list(FIG3_METHODS) * points:
        fail(f"fig3: methods {[m for m, _, _ in out['fig3']]}, want "
             f"{list(FIG3_METHODS)} x {points}")
    for m, pts in curve.items():
        for i, (t, _) in enumerate(pts):
            want = 3 * per_row[m] * rows * every * (i + 1) / 1e12
            if abs(t - want) > 1e-9 * want:
                fail(f"fig3 {m} point {i}: {t} client TFLOPs, want {want}")
        if not all(a[0] < b[0] for a, b in zip(pts, pts[1:])):
            fail(f"fig3 {m}: client TFLOPs not strictly rising {pts}")
    for i in range(points):
        s, f, lb = (curve[m][i][0] for m in FIG3_METHODS)
        if not (s < f and s < lb and f == lb):
            fail(f"fig3 point {i}: splitNN {s}, fedavg {f}, large_batch "
                 f"{lb} TFLOPs")
    final = {m: pts[-1][1] for m, pts in curve.items()}
    for m, acc in final.items():
        if not acc >= FIG3_MIN_ACC[m]:
            fail(f"fig3 {m}: final held-out accuracy {acc:.4f} below "
                 f"{FIG3_MIN_ACC[m]} (chip_spread.py fig3)")
    print(f"fig3 ({cfg.name}, {V_CLIENTS} clients x {rows} rows, "
          f"{V_ROUNDS} rounds, {wall:.1f} s): " + json.dumps(
              {m: [[t, a] for t, a in pts] for m, pts in curve.items()}))
    return {"launches": launches, "wall_s": wall, "final_accuracy": final,
            "client_tflops": {m: pts[-1][0] for m, pts in curve.items()}}


def _wire_bytes_ok(w, quantized: bool) -> bool:
    n = 1
    for s in w["shape"]:
        n *= s
    if quantized:       # int8 values and one fp32 scale a last-axis row
        return w["bytes"] == n + 4 * (n // w["shape"][-1])
    return w["bytes"] == 4 * n


def examples_path(torch) -> dict:
    """Each example's `main()` on the card at the reference's sizes (the
    100M driver at its ~100M size, not --tiny), its own asserts passing,
    launch counters zeroed just before and read just after: quickstart
    and the 100M driver launch `_lm_turn_launches` of their configs
    exactly, the multimodal example one `splitcat_linear` (its fused
    evaluation, equal to `Session.evaluate`'s accuracy), multi-hop none;
    each wire report's bytes are its shapes' (int8 plus a scale a row
    under quickstart's quantize_int8, fp32 otherwise).  Returns
    {path: result}."""
    from repro_torch.kernels import ops

    out = {}
    for name in EXAMPLE_NAMES:
        ex = _example(name)
        want = _no_launches()
        if name == "quickstart":
            want = _lm_turn_launches(ex.config(), ex.CUT, ex.STEPS)
            tokens = ex.STEPS * ex.BATCH * ex.SEQ
        elif name == "e2e_train_100m":
            cfg, steps, b, s = ex.config(False)
            want = _lm_turn_launches(cfg, ex.cut_of(cfg), steps)
            tokens = steps * b * s
        elif name == "multimodal_vertical":
            want = {**want, "splitcat_linear": 1}
            tokens = None
        else:
            tokens = None
        ops.reset_launches()
        t0 = time.perf_counter()
        res = ex.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        hold_launches(launches, want)
        if not all(_wire_bytes_ok(w, name == "quickstart")
                   for w in res["wire_report"]):
            fail(f"example {name}: wire report {res['wire_report']}")
        if name == "multimodal_vertical" and not (
                res["accuracy_fused"] == res["accuracy"] > 0.8):
            fail(f"example {name}: fused {res['accuracy_fused']} vs "
                 f"Session.evaluate {res['accuracy']}")
        path = f"example_{name}"
        out[path] = {"launches": launches, "wall_s": wall,
                     "first_loss": res["losses"][0],
                     "last_loss": res["losses"][-1],
                     "wire": [[w["name"], list(w["shape"]), w["bytes"]]
                              for w in res["wire_report"]]}
        if tokens is not None:
            out[path]["tokens_per_s"] = tokens / wall
        if name == "e2e_train_100m":
            out[path].update(params=res["params"],
                             fit_tokens_per_s=res["tok_s"])
        print(f"example {name}: {wall:.2f} s wall"
              + (f", {tokens / wall:,.0f} tokens/s" if tokens else "")
              + f", loss {res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}"
              f", launches held: { {k: v for k, v in launches.items() if v} }")
        del res
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 3q: VLM serving (InternVL2-2B whole, split, patch inputs)
# ---------------------------------------------------------------------------

VLM_ARCH = "internvl2_2b"
VLM_PATH, VLM_BAT_PATH = "internvl2_serving", "internvl2_batcher_serving"
VLM_SLOTS, VLM_TENANTS = 4, 6
VLM_PROMPTS, VLM_NEW = (16, 128), (8, 32)


def vlm_tenants() -> list:
    return bat_tenants(VLM_TENANTS, VLM_PROMPTS, VLM_NEW, seed=SEED + 5)


def vlm_max_len(cfg) -> int:
    """Every cache row a VLM request can fill: its patches first, then the
    longest prompt and budget of phase 3q."""
    return (cfg.n_patches + max(PROMPT, VLM_PROMPTS[1])
            + max(GEN, VLM_NEW[1]) + 1)


def vlm_payloads(torch) -> list:
    """Phase 3q's wire payloads a counted run: the split session's prefill
    (the patches' rows and the prompt's) and decode as phase 3's, then the
    Batcher's as phase 3o's, each join sending its tenant's patches and
    prompt up."""
    cfg = _config(VLM_ARCH)
    d, v, bf, p = cfg.d_model, cfg.vocab, cfg.dtype, cfg.n_patches
    tenants = vlm_tenants()
    steps = bat_schedule(tenants, VLM_SLOTS)
    n = len(tenants)
    return [(VLM_PATH, "prefill up (patches + prompt)", (B, p + PROMPT, d),
             bf, (1, 1)),
            (VLM_PATH, "decode up", (B, 1, d), bf, (GEN - 1,) * 2),
            (VLM_PATH, "down (logits)", (B, 1, v), bf, (GEN, GEN)),
            *((VLM_BAT_PATH, f"join up (patches + prompt {s})",
               (1, p + s, d), bf, (1, 1)) for s, _ in tenants),
            (VLM_BAT_PATH, "join down (logits)", (1, 1, v), bf, (n, n)),
            (VLM_BAT_PATH, "step up (a tenant's row, the pad row once)",
             (1, 1, d), bf, (sum(steps) + 1, 0)),
            (VLM_BAT_PATH, "step stacked up (residual)", (VLM_SLOTS, 1, d),
             bf, (0, len(steps))),
            (VLM_BAT_PATH, "step down (stacked logits)", (VLM_SLOTS, 1, v),
             bf, (len(steps), len(steps)))]


def _patches(torch, cfg, rows: int, gen, device="cuda"):
    """Seeded stand-ins for the vision frontend's output, 0.02 x normal in
    the model's dtype, as the reference's launchers draw them."""
    return (0.02 * torch.randn((rows, cfg.n_patches, cfg.vision_dim),
                               generator=gen, device=device)).to(cfg.dtype)


def vlm_phase(torch) -> dict:
    """InternVL2-2B whole (24 layers, bf16, seeded weights) split at 4
    over the physical int8 wire with the fused entry: batch 4, 256
    patches and a 128-token prompt a request, 32 tokens.  Launches exact,
    the wire bytes exactly (2,052 + 92,557 a token a row; the prefill
    384 x 2,052 up and 92,557 down a row), the records the real prefill
    and decode step bill == `prefill_cost` / `decode_cost`'s, physical ==
    fake, monolithic (`LM.prefill` with the patches, then
    `greedy_decode_scan`) == the split dense-wire session, bitwise.  Then
    a `Batcher` of 4 slots serving 6 seeded tenants, each with its own
    patches: bytes, tokens and launches exact, each first token its solo
    B=1 stream's."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.nn.module import param_count
    from repro_torch.serve import (Batcher, ServePlan, ServeSession,
                                   greedy_decode_scan)

    cfg = _config(VLM_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = model.init(gen, "cuda")
    n_params = param_count(params)
    p, max_len = cfg.n_patches, vlm_max_len(cfg)
    gen.manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                            device="cuda")
    extra = {"patch_embeds": _patches(torch, cfg, B, gen)}
    print(f"VLM serving: {cfg.name} {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, SwiGLU {cfg.d_ff}, vocab {cfg.vocab}, "
          f"vision_proj {cfg.vision_dim} -> {cfg.d_model}, {n_params} "
          f"parameters, {cfg.dtype}; cut {CUT}, batch {B}, {p} patches + "
          f"prompt {PROMPT}, generate {GEN}, rings of {max_len}")

    def session(wire, fused, slots=B):
        return ServeSession(ServePlan(arch=cfg, cut=CUT, wire=wire,
                                      max_batch=slots, max_len=max_len,
                                      fused_entry=fused), params,
                            device="cuda")

    fused = session("quantize_int8:physical", True)
    billed = []

    def meter(fn):
        def metered(wires, name, t, direction):
            out = fn(wires, name, t, direction)
            billed.append(wires[-1])
            return out
        return metered
    # the warmup (a prefill and one decode step), its records kept
    with patched({("repro_torch.serve.split_infer", "record"): meter}):
        fused.generate(prompts, 2, extra)
    torch.cuda.synchronize()

    ops.reset_launches()
    t0 = time.perf_counter()
    tok0 = fused.prefill(prompts, extra)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    rest = fused.decode(tok0, GEN - 1)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    launches = ops.launch_counts()
    toks = torch.cat([tok0, rest], dim=1)
    step_ms = t_decode / (GEN - 1) * 1e3
    print(f"  prefill {t_prefill:.4f} s; decode {GEN - 1} steps "
          f"{t_decode:.4f} s = {step_ms:.3f} ms a step = "
          f"{B * (GEN - 1) / t_decode:.1f} tok/s")
    print(f"  launches: {launches}")
    # as phase 3: rmsnorm 2 a layer and the final norm at prefill, the
    # entry's norm folded into the scales at decode; flash once a layer
    # at prefill, at the 384-row shape
    hold_launches(launches, {
        "wire_quant": 2 + 2 * (GEN - 1), "wire_dequant": 2 + 2 * (GEN - 1),
        "splitcat_linear_q8": GEN - 1, "splitcat_linear": 0,
        "rmsnorm": (2 * cfg.n_layers + 1) + (GEN - 1) * 2 * cfg.n_layers,
        "rmsnorm_bwd": 0, "ssd_scan": 0, "flash_attention": cfg.n_layers})
    if tuple(toks.shape) != (B, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        fail(f"{cfg.name}: tokens {tuple(toks.shape)} outside ({B}, {GEN}) "
             f"x [0, {cfg.vocab})")
    tok = rest[:, -1:]

    def step():
        nonlocal tok
        tok = fused.decode_step(tok)
    busy_ms = profile_device(torch, f"{cfg.name} decode step", step,
                             step_ms / 1e3)

    # the bytes: analytic, probed and billed by the real run
    up, down = cfg.d_model + 4, cfg.vocab + 4
    per_tok = fused.bytes_per_token()
    dc = fused.decode_cost(batch=B)
    pc = fused.prefill_cost(B, PROMPT, extra)
    if per_tok != up + down or dc.bytes_up + dc.bytes_down != B * per_tok:
        fail(f"{cfg.name}: {per_tok} wire B a token, not {up + down}")
    if (pc.bytes_up, pc.bytes_down) != (B * (p + PROMPT) * up, B * down):
        fail(f"{cfg.name}: prefill bills {pc.bytes_up} up, {pc.bytes_down} "
             f"down, not {B * (p + PROMPT) * up} and {B * down}")

    def recs(ws):
        return [(w.name, tuple(w.shape), w.direction, w.bytes, w.physical)
                for w in ws]
    if recs(billed) != recs(pc.wires + dc.wires):
        fail(f"{cfg.name}: the run billed {recs(billed)}, the probes "
             f"{recs(pc.wires + dc.wires)}")
    print(f"  wire: {per_tok} B a generated token a row (up {up}, down "
          f"{down}); prefill {pc.bytes_up // B} B up ({p + PROMPT} rows) "
          f"and {pc.bytes_down // B} B down a row; the real prefill and "
          "decode step billed what prefill_cost and decode_cost price")

    phys = session("quantize_int8:physical", False).generate(prompts, GEN,
                                                             extra)
    fake = session("quantize_int8", False).generate(prompts, GEN, extra)
    if not torch.equal(phys, fake):
        fail(f"{cfg.name}: physical-wire tokens {phys.tolist()} != fake-wire "
             f"tokens {fake.tolist()}")
    cache = model.init_cache(B, max_len, "cuda")
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompts, **extra},
                                      cache)
        first = torch.argmax(logits[:, -1], dim=-1)[:, None]
        mono_rest, _ = greedy_decode_scan(model, params, cache, first,
                                          GEN - 1)
    mono = torch.cat([first, mono_rest], dim=1)
    split = session("", False).generate(prompts, GEN, extra)
    if not torch.equal(mono, split):
        fail(f"{cfg.name}: monolithic tokens {mono.tolist()} != split "
             f"dense-wire tokens {split.tolist()}")
    del cache, logits
    print(f"  physical == fake wire tokens, and monolithic == split "
          f"(dense wire, cut {CUT}) tokens, bitwise ({B}x{GEN}); the fused "
          f"entry shares {int((phys == toks).sum())}/{B * GEN} tokens with "
          "the unfused physical run")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    out = {VLM_PATH: {
        "launches": launches, "params": n_params, "prefill_s": t_prefill,
        "decode_step_ms": step_ms,
        "decode_tok_per_s": B * (GEN - 1) / t_decode, "busy_ms": busy_ms,
        "busy_share": busy_ms / step_ms if busy_ms else None,
        "peak_gib": peak, "wire_bytes_per_token": per_tok,
        "prefill_bytes_up_per_row": pc.bytes_up // B,
        "prefill_bytes_down_per_row": pc.bytes_down // B}}
    print(f"  peak {peak:.2f} GiB allocated (weights, five sessions' "
          "caches, the monolithic run's)")

    # the Batcher: 6 tenants, each its own patches, through 4 slots
    tenants = vlm_tenants()
    budgets = [n for _, n in tenants]
    tprompts = _bat_prompts(torch, tenants, cfg.vocab, seed=SEED + 6)
    pgen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    extras = [{"patch_embeds": _patches(torch, cfg, 1, pgen)}
              for _ in tenants]
    print(f"  Batcher: {VLM_SLOTS} slots, {VLM_TENANTS} tenants "
          f"(prompt, max_new) {tenants}, {p} patches each")
    sess = session("quantize_int8:physical", True, VLM_SLOTS)
    warm = Batcher(sess)                          # warmup
    run_queue(torch, warm, tprompts[:2], [2, 2], extras=extras[:2])
    torch.cuda.synchronize()
    del warm
    bat = Batcher(sess)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, steps = run_queue(torch, bat, tprompts, budgets, extras=extras)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b_launches = ops.launch_counts()
    if steps != bat_schedule(tenants, VLM_SLOTS):
        fail(f"VLM batcher steps {steps} != the schedule "
             f"{bat_schedule(tenants, VLM_SLOTS)}")
    hold_launches(b_launches, _bat_want_launches(tenants, steps, cfg, CUT))
    lens = [len(t.tokens) for t in done]
    want_bytes = sum((p + s) * up + down + (n - 1) * (up + down)
                     for s, n in tenants)
    if lens != budgets or bat.tokens_generated != sum(budgets) or \
            bat.bytes_up + bat.bytes_down != want_bytes:
        fail(f"VLM batcher: tokens {lens} (want {budgets}), counted "
             f"{bat.tokens_generated}; bytes {bat.bytes_up} + "
             f"{bat.bytes_down} != {want_bytes}")
    solo = session("quantize_int8:physical", True, 1)
    firsts = [int(solo.generate(pr[None], 1, ex)[0, 0])
              for pr, ex in zip(tprompts, extras)]
    if firsts != [t.tokens[0] for t in done]:
        fail(f"VLM batcher first tokens {[t.tokens[0] for t in done]} != "
             f"solo {firsts}")
    print(f"  Batcher: {len(steps)} steps, live a step {steps}; launches "
          f"exact {b_launches}; bytes exact: up {bat.bytes_up} + down "
          f"{bat.bytes_down} = {want_bytes}, {bat.tokens_generated} tokens; "
          f"first tokens == solo B=1; {wall:.3f} s wall = "
          f"{bat.tokens_generated / wall:.1f} tok/s (joins included)")
    out[VLM_BAT_PATH] = {"launches": b_launches, "steps": len(steps),
                         "wall_s": wall,
                         "tok_per_s": bat.tokens_generated / wall,
                         "bytes": want_bytes,
                         "tokens": bat.tokens_generated}
    del fused, sess, solo, bat, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def reduced_vlm_against_cpu(torch):
    """Reduced fp32 InternVL2 (8 patches of 64) served split on the card
    and on the CPU from the same weights and patches, over the physical
    wire through the fused entry: the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import ServePlan, ServeSession

    cfg = get_config(VLM_ARCH).reduced(vocab=97)
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg).init(gen, "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 7), generator=gen)
    extra = {"patch_embeds": _patches(torch, cfg, 2, gen, "cpu")}
    plan = ServePlan(arch=cfg, wire="quantize_int8:physical", max_batch=2,
                     max_len=cfg.n_patches + 15, fused_entry=True)
    on_cpu = ServeSession(plan, params, device="cpu").generate(prompts, 6,
                                                               extra)
    on_card = ServeSession(plan, params, device="cuda").generate(prompts, 6,
                                                                 extra)
    if not torch.equal(on_cpu, on_card.cpu()):
        fail(f"reduced VLM: card tokens {on_card.tolist()} != CPU tokens "
             f"{on_cpu.tolist()}")
    print(f"reduced {cfg.name}, card == CPU plain path: {on_cpu.tolist()}")


# ---------------------------------------------------------------------------
# phase 3r: encoder-decoder serving (Whisper-base), and both families in
# the training CLI
# ---------------------------------------------------------------------------

ENC_ARCH = "whisper_base"
ENC_PATH = "whisper_monolithic_serving"
ENC_PROMPT = 64
# a bf16 incremental logit's largest difference from the teacher-forced
# one, as a share of the top logit (the bound phase 3o holds a batched row
# to; a wrong cache or position differs by O(1)); in fp32 an absolute
# 1e-4, the reference test's tolerance
ENC_REL = 0.05
ENC_ABS32 = 1e-4
# the training runs: (path, arch, argv, steps), batch CLI_B, text FAM_SEQ
FAM_SEQ = 64
FAM_RUNS = [
    ("whisper_base_cli_monolithic", ENC_ARCH, ["--mode", "monolithic"],
     CLI_STEPS),
    ("whisper_base_cli_fedavg", ENC_ARCH,
     ["--mode", "fedavg", "--n-clients", "2"], CLI_SHORT),
    ("whisper_base_cli_large_batch", ENC_ARCH,
     ["--mode", "large_batch", "--n-clients", "2"], CLI_SHORT),
    ("internvl2_2b_cli_monolithic", VLM_ARCH, ["--mode", "monolithic"],
     CLI_STEPS)]
# InternVL2 trains at the deepest depth whose bf16 AdamW state (about 22
# bytes a stored parameter, phase 3k's count) and FAM_ACT_GIB of
# activations and logits leave FAM_FREE_GIB of the card free
FAM_FREE_GIB, FAM_ACT_GIB, FAM_BYTES_PER_PARAM = 8, 16, 22


def _flash_by_mode(counts: dict):
    """A wrapper of `ops.flash_attention` that counts its calls by `causal`
    (the launch counter cannot tell the modes apart), but those on meta
    tensors (a FLOP or wire probe), which launch nothing."""
    def wrap(fn):
        def counted(q, *args, causal=True, **kw):
            if q.device.type != "meta":
                counts[causal] = counts.get(causal, 0) + 1
            return fn(q, *args, causal=causal, **kw)
        return counted
    return wrap


def _forced_agree(torch, inc, tf, toks, tol: float, what: str) -> str:
    """Incremental logits `inc` and teacher-forced ones `tf` (B, n, V) of
    the generated tokens `toks` (B, n): every logit within `tol` (an
    absolute bound), and each token tf's argmax wherever tf's top two
    differ by more than twice the measured difference (where they differ
    by less, either argmax is the model's)."""
    diff = (inc.float() - tf.float()).abs().amax(dim=-1)        # (B, n)
    if float(diff.max()) > tol:
        fail(f"{what}: incremental logits differ from the teacher-forced "
             f"ones by {float(diff.max()):.4g}, above {tol:.4g}")
    top2 = tf.float().topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    same = torch.argmax(tf, dim=-1) == toks
    decided = gap > 2 * diff
    if bool((decided & ~same).any()):
        fail(f"{what}: a generated token is not the teacher-forced argmax "
             "though the logits' difference cannot move it")
    return (f"logits within {float(diff.max()):.3g} (limit {tol:.3g}); "
            f"{int(same.sum())}/{same.numel()} tokens the teacher-forced "
            f"argmax, every one of the {int(decided.sum())} the difference "
            "cannot move")


def _whisper_inputs(torch, cfg, device="cuda", batch=B, prompt=ENC_PROMPT):
    """The serve CLI's draws: weights from seed 0, then the prompt and the
    frames from seed 1."""
    from repro_torch.models import build_model

    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device)
    gen.manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                           device=device)
    audio = (0.02 * torch.randn((batch, cfg.n_audio_frames, cfg.d_model),
                                generator=gen, device=device)).to(cfg.dtype)
    return model, params, tokens, audio


def _incremental(torch, model, params, tokens, audio, toks, max_len):
    """The logits behind each generated token: the prefill's last, then a
    decode step on each generated token but the last."""
    with torch.no_grad():
        cache = model.init_cache(params, audio, max_len)
        logits, cache = model.prefill(params, tokens, cache)
        out = [logits[:, -1:]]
        for i in range(toks.shape[1] - 1):
            lg, cache = model.decode_step(params, toks[:, i:i + 1], cache)
            out.append(lg)
    return torch.cat(out, dim=1)


def _teacher_forced(torch, model, params, tokens, audio, toks):
    """`decode_full` over the prompt and every generated token but the
    last: the logits that pick each generated token."""
    with torch.no_grad():
        full = model.decode_full(params, torch.cat([tokens, toks[:, :-1]],
                                                   1),
                                 model.encode(params, audio))
    return full[:, tokens.shape[1] - 1:]


def whisper_serve(torch) -> dict:
    """Whisper-base whole through the serve CLI (monolithic, bf16, batch 4,
    prompt 64, 32 tokens, 1,500 frames): the JSON line; per prefill
    exactly 6 non-causal and 6 causal flash launches (encoder, decoder
    self-attention), no rmsnorm and no wire kernel; the generated tokens
    against `decode_full` re-run teacher-forced over them (ENC_REL), and
    at full size in fp32 the reference's prefill == decode-loop test
    (last prompt logits within 1e-4) and the same teacher-forced check
    within 1e-4."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.nn.module import param_count
    from repro_torch.serve import greedy_decode_scan

    cfg = _config(ENC_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", ENC_ARCH, "--batch", str(B), "--prompt-len",
            str(ENC_PROMPT), "--gen", str(GEN)]
    by_mode: dict = {}
    ops.reset_launches()
    with patched({("repro_torch.kernels.ops", "flash_attention"):
                  _flash_by_mode(by_mode)}):
        run, summary = _serve_cli(torch, argv, cfg)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the CLI's warmup and timed run: two prefills
    hold_launches(launches, {
        "flash_attention": 2 * (cfg.n_enc_layers + cfg.n_layers),
        "rmsnorm": 0, "rmsnorm_bwd": 0, "wire_quant": 0, "wire_dequant": 0,
        "splitcat_linear_q8": 0, "splitcat_linear": 0, "ssd_scan": 0})
    if by_mode != {False: 2 * cfg.n_enc_layers, True: 2 * cfg.n_layers}:
        fail(f"{cfg.name}: flash calls by causal {by_mode}, not "
             f"{cfg.n_enc_layers} non-causal and {cfg.n_layers} causal a "
             "prefill")
    want = {"arch", "batch", "prompt_len", "generated", "device", "mode",
            "prefill_s", "decode_s", "decode_tok_per_s", "sample_tokens"}
    if set(summary) != want or summary["mode"] != "monolithic" or \
            summary["device"] != torch.cuda.get_device_name(0):
        fail(f"{cfg.name} serve CLI: summary {summary}")
    toks = run.tokens
    if tuple(toks.shape) != (B, GEN) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        fail(f"{cfg.name}: tokens {tuple(toks.shape)}")
    step_ms = summary["decode_s"] / (GEN - 1) * 1e3
    tok = toks[:, -1:]

    def step():
        nonlocal tok
        tok = run.step(tok)
    busy_ms = profile_device(torch, f"{cfg.name} monolithic decode step",
                             step, step_ms / 1e3, steps=4)
    print(f"  {cfg.name} monolithic: prefill {summary['prefill_s']:.4f} s "
          f"(the encoder over {cfg.n_audio_frames} frames included), decode "
          f"{step_ms:.3f} ms a step = {summary['decode_tok_per_s']:.1f} "
          f"tok/s, peak {peak:.2f} GiB; launches {launches}, flash by "
          f"causal {by_mode}")
    del run
    max_len = ENC_PROMPT + GEN + 1
    model, params, tokens, audio = _whisper_inputs(torch, cfg)
    n_params = param_count(params)
    inc = _incremental(torch, model, params, tokens, audio, toks, max_len)
    tf = _teacher_forced(torch, model, params, tokens, audio, toks)
    top = float(tf.float().abs().max())
    said = _forced_agree(torch, inc, tf, toks, ENC_REL * top,
                         f"{cfg.name} bf16")
    print(f"  bf16 CLI tokens against decode_full teacher-forced: {said}")
    del params, inc, tf
    # the reference's prefill == decode-loop test at full size, in fp32
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model, params, tokens, audio = _whisper_inputs(torch, cfg32)
    with torch.no_grad():
        cache_l = model.init_cache(params, audio, max_len)
        for i in range(ENC_PROMPT):
            loop, cache_l = model.decode_step(params, tokens[:, i:i + 1],
                                              cache_l)
        cache_p = model.init_cache(params, audio, max_len)
        pre, cache_p = model.prefill(params, tokens, cache_p)
        err = float((loop[:, -1] - pre[:, -1]).abs().max())
        if err > ENC_ABS32:
            fail(f"{cfg.name} fp32: prefill's last logits differ from the "
                 f"decode loop's by {err:.3g}")
        first = torch.argmax(pre[:, -1], -1)[:, None]
        rest, _ = greedy_decode_scan(model, params, cache_p, first, GEN - 1)
    toks32 = torch.cat([first, rest], 1)
    said32 = _forced_agree(
        torch, _incremental(torch, model, params, tokens, audio, toks32,
                            max_len),
        _teacher_forced(torch, model, params, tokens, audio, toks32),
        toks32, ENC_ABS32, f"{cfg.name} fp32")
    print(f"  fp32 at full size: prefill's last logits within {err:.3g} of "
          f"a {ENC_PROMPT}-step decode loop's; greedy tokens against "
          f"decode_full teacher-forced: {said32}")
    del params, cache_l, cache_p
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "params": n_params,
            "prefill_s": summary["prefill_s"], "decode_step_ms": step_ms,
            "decode_tok_per_s": summary["decode_tok_per_s"],
            "busy_ms": busy_ms, "peak_gib": peak}


def reduced_whisper_against_cpu(torch):
    """Reduced fp32 Whisper (16 frames) served monolithically on the card
    and on the CPU from the same weights, frames and prompt: the same
    tokens."""
    from repro_torch.configs import get_config
    from repro_torch.nn.module import tree_map
    from repro_torch.serve import greedy_decode_scan

    cfg = get_config(ENC_ARCH).reduced(vocab=97)
    model, params, tokens, audio = _whisper_inputs(torch, cfg, "cpu", 2, 7)
    out = {}
    for device in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(device), params)
        with torch.no_grad():
            cache = model.init_cache(p, audio.to(device), 15)
            logits, cache = model.prefill(p, tokens.to(device), cache)
            first = torch.argmax(logits[:, -1], -1)[:, None]
            rest, _ = greedy_decode_scan(model, p, cache, first, 5)
        out[device] = torch.cat([first, rest], 1).cpu()
    if not torch.equal(out["cpu"], out["cuda"]):
        fail(f"reduced Whisper: card tokens {out['cuda'].tolist()} != CPU "
             f"tokens {out['cpu'].tolist()}")
    print(f"reduced {cfg.name}, card == CPU plain path: "
          f"{out['cpu'].tolist()}")


def fam_config(torch, arch):
    """The config a training run of phase 3r takes: Whisper-base whole,
    InternVL2-2B at full width and the deepest depth its bf16 AdamW
    training leaves FAM_FREE_GIB free at (from the model on meta)."""
    import dataclasses

    from repro_torch.models import build_model
    from repro_torch.nn.module import param_count

    cfg = _config(arch)
    if arch != VLM_ARCH:
        return cfg

    def size(n):
        m = build_model(dataclasses.replace(cfg, n_layers=n))
        return param_count(m.init(torch.Generator(), "meta"))
    layer = size(2) - size(1)
    base = size(1) - layer
    total = torch.cuda.get_device_properties(0).total_memory
    room = (total - (FAM_FREE_GIB + FAM_ACT_GIB) * 2 ** 30
            - base * FAM_BYTES_PER_PARAM)
    n = min(cfg.n_layers, int(room // (layer * FAM_BYTES_PER_PARAM)))
    print(f"  {cfg.name} training: {layer} parameters a layer, {base} "
          f"outside the layers; {n} of its {cfg.n_layers} layers leave "
          f"{FAM_FREE_GIB} GiB free at {FAM_BYTES_PER_PARAM} B a parameter "
          f"and {FAM_ACT_GIB} GiB of activations")
    return dataclasses.replace(cfg, n_layers=n)


def fam_cli_run(torch, path, arch, argv, steps) -> dict:
    """One training CLI run of phase 3r, in-process, bf16, batch CLI_B,
    text FAM_SEQ (a VLM's 256 patches in front), ids below
    CLI_DATA_VOCAB: launches exact (flash once an attention layer a
    forward, Whisper's encoder layers non-causal; rmsnorm 2L + 1 a VLM
    forward and its backward kernels; no wire kernel), the loss falling
    over CLI_STEPS steps, ms a step and the peak."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.nn.module import param_count

    cfg = fam_config(torch, arch)
    full = ["--arch", arch, "--batch", str(CLI_B), "--seq", str(FAM_SEQ),
            "--steps", str(steps), "--log-every", "0"] + argv
    a = train.parser().parse_args(full)
    k = {"monolithic": 1, "large_batch": a.n_clients,
         "fedavg": a.n_clients * a.local_steps}[a.mode]
    fwd = steps * k + 1                   # the steps' forwards, the eval's
    enc = cfg.n_enc_layers if cfg.encdec else 0
    norms = 0 if cfg.norm == "layernorm" else 2 * cfg.n_layers + 1
    want = {"flash_attention": fwd * (cfg.n_layers + enc),
            "rmsnorm": fwd * norms,
            "rmsnorm_bwd": RMS_BWD_KERNELS * norms * steps * k,
            "wire_quant": 0, "wire_dequant": 0, "splitcat_linear_q8": 0,
            "splitcat_linear": 0, "ssd_scan": 0}
    extra = (f"{cfg.n_audio_frames} frames" if cfg.encdec
             else f"{cfg.n_patches} patches")
    print(f"{path.replace('_', ' ')} path: python -m repro_torch.launch.train "
          f"{' '.join(full)} ({cfg.name}, {cfg.n_layers} layers"
          + (f" + {enc} encoder layers" if enc else "")
          + f", d_model {cfg.d_model}, {extra}, bf16; ids below "
          f"{CLI_DATA_VOCAB})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    by_mode: dict = {}
    ops.reset_launches()
    t0 = time.perf_counter()
    with patched({("repro_torch.kernels.ops", "flash_attention"):
                  _flash_by_mode(by_mode)}):
        run, summary = _run_cli(torch, full, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hold_launches(launches, want)
    if enc and by_mode != {False: fwd * enc, True: fwd * cfg.n_layers}:
        fail(f"{path}: flash calls by causal {by_mode}")
    ls = run.losses
    if not all(map(math.isfinite, ls)) or (summary["first_loss"], summary[
            "final_loss"]) != (ls[0], ls[-1]) or len(ls) != steps:
        fail(f"{path}: losses {ls}, summary {summary}")
    if steps == CLI_STEPS and not ls[-1] < ls[0]:
        fail(f"{path}: final loss {ls[-1]} not below the first {ls[0]}")
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    if total - peak < FAM_FREE_GIB:
        fail(f"{path}: peak {peak:.2f} GiB leaves less than {FAM_FREE_GIB} "
             f"GiB of {total:.2f} free")
    n_params = param_count(run.session.state["global"])
    # ms a step past the run: 2 more rounds under CUDA events
    bs = [run.session._prep(run.round_batches(steps + 2 + i))
          for i in range(2)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for b in bs:
        run.session.run_round(b)
    end.record()
    end.synchronize()
    round_ms = start.elapsed_time(end) / 2
    print(f"  {n_params} parameters; {wall:.3f} s, peak {peak:.2f} GiB; "
          f"launches exact {launches}"
          + (f", flash by causal {by_mode}" if enc else "")
          + f"; {round_ms:.3f} ms a step (CUDA events over 2); first loss "
          f"{ls[0]:.4f}, final {ls[-1]:.4f}")
    del run, bs
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "layers": cfg.n_layers, "params": n_params,
            "round_ms": round_ms, "peak_gib": peak, "wall_s": wall,
            "first_loss": ls[0], "final_loss": ls[-1],
            "eval_acc_per_client": summary["eval_acc_per_client"]}


def encdec_phase(torch) -> dict:
    """Phase 3r: Whisper-base served through the serve CLI, then the
    training CLI over both families, and `--mode split` refused for
    both with a message naming ROADMAP.md."""
    from repro_torch.launch import train

    out = {ENC_PATH: whisper_serve(torch)}
    for run in FAM_RUNS:
        out[run[0]] = fam_cli_run(torch, *run)
    for arch in (ENC_ARCH, VLM_ARCH):
        try:
            train.main(["--arch", arch, "--reduced", "--mode", "split",
                        "--steps", "1"])
        except SystemExit as e:
            if "ROADMAP.md" not in str(e):
                fail(f"{arch} --mode split: {e}")
            print(f"  {arch} --mode split exits: {e}")
        else:
            fail(f"{arch} --mode split trained")
    return out


# ---------------------------------------------------------------------------
# phase 3s: the fleet (clients sharded over ranks), one rank on the card
# ---------------------------------------------------------------------------

# the Table 1 setup of phases 3e-3h over `Plan(fleet=FleetSpec(n_devices=
# 1))`, an NCCL group of one rank, each path against the single-device
# `Session` from the same seed and data
FLEET_ROUNDS = 3
FLEET_RUNS = (("vanilla", None), ("vanilla", "parallel"), ("fedavg", None),
              ("large_batch", None))
FLEET_CLI = ("mamba2_130m_cli_split_parallel_fleet", "mamba2_130m",
             ["--mode", "split", "--n-clients", "2", "--wire", CLI_WIRE,
              "--schedule", "parallel", "--fleet"], CLI_SHORT)


def fleet_path_name(mode: str, schedule: str | None = None) -> str:
    return path_name(mode, schedule).replace("_training", "_fleet_training")


def _fleet_vgg_payloads(torch, mode: str, schedule: str | None) -> list:
    """A VGG-16 path's payloads over FLEET_ROUNDS rounds: a one-rank fleet
    sends what one device does."""
    kw = dict(rounds=FLEET_ROUNDS, path=fleet_path_name(mode, schedule))
    return (_turn_payloads(torch, mode, schedule, **kw)
            if mode in TURN_KINDS else
            _baseline_payloads(torch, mode, schedule, **kw))


def fleet_payloads(torch) -> list:
    """Phase 3s's wire payloads: each VGG-16 path's and the CLI run's."""
    return [p for mode, schedule in FLEET_RUNS
            for p in _fleet_vgg_payloads(torch, mode, schedule)] + _cli_plan(
                torch, *FLEET_CLI)["payloads"]


def fleet_path(torch, mode: str, schedule: str | None = None) -> dict:
    """One VGG-16 path (Table 1's setup: 4 clients of 128 rows, the
    physical wire, AdamW 1e-4) for FLEET_ROUNDS rounds on one device and
    as a one-rank fleet, from one seed and the same data under
    deterministic cuDNN: losses, the (gathered) state, the meter, the
    wire report and every client's accuracy bitwise; launches exact and
    equal; ms a round from CUDA events; the collectives a round."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.api import FleetSpec, leakage_probe, quantize_int8
    from repro_torch.configs.vgg_cifar10 import CONFIG
    from repro_torch.data.synthetic import image_batch
    from repro_torch.kernels import ops
    from repro_torch.nn.module import tree_leaves

    path = fleet_path_name(mode, schedule)
    phys = [quantize_int8(physical=True), leakage_probe()]
    plan = (_turn_plan(CONFIG, mode, phys, V_CLIENTS,
                       TURN_KINDS[mode]["cuts"], schedule)
            if mode in TURN_KINDS else
            _baseline_plan(CONFIG, mode, phys, V_CLIENTS))
    print(f"{path.replace('_', ' ')} path: {CONFIG.name} {mode}"
          + (f" ({schedule})" if schedule else "")
          + f", {V_CLIENTS} clients of {VB} rows, {FLEET_ROUNDS} rounds, "
          f"AdamW({LR}), physical int8 wire: Plan(fleet=FleetSpec("
          f"n_devices=1)) against the single-device Session")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    batches = _client_batches(gen, FLEET_ROUNDS, V_CLIENTS, VB, N_CLASSES)
    ev = image_batch(gen, EVAL_B, N_CLASSES)
    ev = {"x": ev["images"], "labels": ev["labels"]}
    payloads = _fleet_vgg_payloads(torch, mode, schedule)
    want = {"wire_quant": sum(p[-1][0] for p in payloads),
            "wire_dequant": sum(p[-1][1] for p in payloads),
            **NO_OTHER_KERNEL}
    runs = {}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for label, p in (("single device", plan), ("fleet", dataclasses.replace(
                plan, fleet=FleetSpec(n_devices=1)))):
            sess = p.compile()
            sess.init(seed=SEED)
            mesh = getattr(sess.engine, "mesh", None)
            if mesh is not None:
                if dist.get_backend() != "nccl" or mesh.device.type != "cuda":
                    fail(f"{path}: the fleet's group is "
                         f"{dist.get_backend()} on {mesh.device}")
                mesh.counts.clear()
            torch.cuda.synchronize()
            ops.reset_launches()
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(FLEET_ROUNDS + 1)]
            marks[0].record()
            losses = []
            for r in range(FLEET_ROUNDS):
                losses.append(sess.run_round(batches[r]))
                marks[r + 1].record()
            marks[-1].synchronize()
            launches = ops.launch_counts()
            counts = dict(mesh.counts) if mesh is not None else {}
            ms = [marks[i].elapsed_time(marks[i + 1])
                  for i in range(FLEET_ROUNDS)]
            hold_launches(launches, want)
            runs[label] = {
                "losses": torch.cat(losses),
                "state": tree_leaves(sess.gather_state()),
                "meter": sess.meter(), "report": sess.wire_report(batches[0]),
                "accs": sess.evaluate_all(ev), "ms": ms,
                "launches": launches, "counts": counts}
            del sess
    finally:
        torch.backends.cudnn.deterministic = False
    a, b = runs["single device"], runs["fleet"]
    same = len(a["state"]) == len(b["state"]) and all(
        torch.equal(x, y) for x, y in zip(a["state"], b["state"]))
    if not (torch.equal(a["losses"], b["losses"]) and same
            and a["meter"] == b["meter"] and a["report"] == b["report"]
            and torch.equal(a["accs"], b["accs"])):
        fail(f"{path}: the one-rank fleet is not bitwise the single device "
             f"(losses {a['losses'].tolist()} vs {b['losses'].tolist()}, "
             f"states equal {same}, meters {a['meter']} / {b['meter']}, "
             f"accuracies {a['accs'].tolist()} / {b['accs'].tolist()})")
    per_round = {k: v / FLEET_ROUNDS for k, v in b["counts"].items()}
    ms_a = statistics.mean(a["ms"][1:])
    ms_b = statistics.mean(b["ms"][1:])
    print(f"  bitwise the single device over {FLEET_ROUNDS} rounds: losses "
          f"{b['losses'].tolist()}, {len(b['state'])} state leaves, meter, "
          f"wire report, accuracies {b['accs'].tolist()}; launches "
          f"{b['launches']}")
    print(f"  ms a round (CUDA events, rounds 2-{FLEET_ROUNDS}): fleet "
          f"{ms_b:.3f}, single device {ms_a:.3f} ({ms_b / ms_a:.3f}x); "
          f"round 1 {b['ms'][0]:.3f} / {a['ms'][0]:.3f}; NCCL collective "
          f"calls a round (one a dtype of the tree): {per_round}")
    return {"launches": b["launches"], "round_ms": ms_b,
            "single_device_round_ms": ms_a, "collectives_a_round": per_round,
            "first_loss": float(b["losses"][0]),
            "last_loss": float(b["losses"][-1]),
            "eval_accuracy": b["accs"].tolist()}


def fleet_cli(torch) -> dict:
    """The training CLI with `--fleet` (Mamba2-130M at `cli_config`'s
    depth, bf16, split
    over 2 clients, the parallel schedule, CLI_SHORT steps) against the
    same run without it, under deterministic algorithms: the JSON lines
    equal but for their wall seconds; launches exact."""
    from repro_torch.engine import FleetRoundEngine
    from repro_torch.kernels import ops

    path, arch, argv, steps = FLEET_CLI
    spec = _cli_plan(torch, *FLEET_CLI)
    full = _cli_argv(path, arch, argv, steps)
    print(f"{path.replace('_', ' ')} path: python -m repro_torch.launch.train "
          f"{' '.join(full)}, against the run without --fleet")
    torch.use_deterministic_algorithms(True)
    try:
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        run, summary = _run_cli(torch, full, spec["cfg"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        engine = type(run.session.engine).__name__
        del run
        _, plain = _run_cli(torch, [a for a in full if a != "--fleet"],
                            spec["cfg"])
    finally:
        torch.use_deterministic_algorithms(False)
    hold_launches(launches, spec["launches"])
    if engine != FleetRoundEngine.__name__:
        fail(f"{path}: the CLI ran {engine}, not the fleet engine")
    walls = summary.pop("wall_s"), plain.pop("wall_s")
    if summary != plain:
        fail(f"{path}: the --fleet JSON line {summary} != {plain}")
    print(f"  the --fleet JSON line equals the run's without it (wall s "
          f"{walls[0]} / {walls[1]}): {summary}; launches {launches}")
    torch.cuda.empty_cache()
    return {"launches": launches, "wall_s": wall,
            "first_loss": summary["first_loss"],
            "final_loss": summary["final_loss"],
            "client_gb": summary["client_gb"]}


def fleet_phase(torch) -> dict:
    """Phase 3s: the one-rank fleet on the card (an NCCL group of one,
    destroyed at the end of the phase, failed or not)."""
    import torch.distributed as dist

    out = {}
    try:
        for mode, schedule in FLEET_RUNS:
            out[fleet_path_name(mode, schedule)] = fleet_path(torch, mode,
                                                              schedule)
        out[FLEET_CLI[0]] = fleet_cli(torch)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# phase 3t: the sharded serving paths at one rank (expert-parallel MoE,
# split-KV decode), the int8 KV cache, and MoE training through the CLI
# ---------------------------------------------------------------------------

EP_ARCH = "qwen3_moe_30b_a3b"
EP_PATH = "qwen3_moe_ep_serving"
# the split-KV and int8 layers: qwen1_5_32b's attention (d 5,120, MHA
# 40/40 of 128, qkv bias), batch 4, the reference's decode_32k ring
# (configs/base.py:121) filled with seeded rows, 16 steps from 32,760
# across the wrap
KV_ARCH, KV_B, KV_RING, KV_POS, KV_STEPS = "qwen1_5_32b", 4, 32768, 32760, 16
# split-KV against the native decode, of the native output's largest
# value; the int8 cache against it (tests/test_perf_paths.py:146's bound)
KV_REL, INT8_REL = 1e-5, 0.05
# MoE and the new dense configs in the training CLI: bf16, AdamW 1e-3,
# batch CLI_B x seq CLI_S, split on the physical wire, CLI_STEPS steps,
# each at the deepest depth whose run leaves FAM_FREE_GIB of the card
# free, over 2 clients where one layer does.  Measured on an H100 80GB
# (79.18 GiB; PERF.md): the engine's round-robin turn replaces the
# stacked client state functionally (`engine/program.py:tree_update`
# clones the stack), so each client's copy of a client side takes about
# 34 B a parameter, and a server parameter about 26.  Qwen3-30B-A3B over
# 2 clients peaks at 71.13 GiB at one layer here (8.05 GiB free, its
# 311M-row embedding stored twice), over 1 client at 69.68 GiB at 3
# layers alone (a 4th adds 15 GiB); DeepSeek-V2 over 2 clients peaks at
# 71.46 GiB at one layer here (7.72 free) and one of its MoE layers
# (3.8B parameters) does not fit at all; ChatGLM3-6B over 2 clients
# peaks at 69.17 GiB at 5 layers and runs out of memory at 6.  These
# runs allocate through expandable segments: with fixed segments
# Qwen3-30B-A3B's one layer over 2 clients left 10 GiB reserved but
# unallocated and ran out of memory.  arch -> (layers, clients)
T_RUNS = {"qwen3_moe_30b_a3b": (3, 1), "deepseek_v2_236b": (1, 1),
          "chatglm3_6b": (5, 2)}


def t_argv(clients: int) -> list:
    return ["--mode", "split", "--n-clients", str(clients), "--wire",
            "quantize_int8:physical"]


def t_path(arch: str) -> str:
    return f"{arch}_cli_split"


def t_config(arch):
    """A phase 3t training run's (config, clients, cut): full width at
    `T_RUNS`'s depth, the CLI's default cut."""
    from repro_torch.configs import get_config

    n, clients = T_RUNS[arch]
    cfg = dataclasses.replace(get_config(arch), n_layers=n)
    return cfg, clients, min(cfg.default_cut, max(1, n // 2))


def t_payloads(torch) -> list:
    out = []
    for arch in T_RUNS:
        cfg, clients, _ = t_config(arch)
        out += _cli_plan(torch, t_path(arch), arch, t_argv(clients),
                         CLI_STEPS, cfg)["payloads"]
    return out


def ep_serving(torch, mesh, gspmd_launches: dict) -> dict:
    """Phase 3t (a): Qwen3-30B-A3B whole, served split as phase 3l serves
    it, with `ep_axis="model"` on every MoE layer over the one-rank
    mesh, in turns with the single-device (GSPMD) path from the same
    weights (GSPMD, EP, GSPMD): tokens and wire bytes bitwise,
    launches exactly phase 3l's, one all_reduce a MoE layer a forward,
    decode ms a step of both."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.models.lm import replace_specs
    from repro_torch.serve import ServePlan, ServeSession

    cfg = get_config(EP_ARCH)
    base = build_model(cfg)
    models = {"gspmd": base,
              "ep": replace_specs(base, moe={"ep_axis": "model"})}
    n_moe = sum(g.n_layers for g in models["ep"].groups
                if g.specs[0].moe is not None)
    print(f"{EP_PATH.replace('_', ' ')} path: {cfg.name} whole ({cfg.n_layers}"
          f" layers, {n_moe} MoE with ep_axis='model' on a {mesh.shape} "
          f"mesh, NCCL group of one), batch {B}, prompt {PROMPT}, generate "
          f"{GEN}, fused entry, physical wire, bf16")
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = base.init(gen, "cuda")
    gen.manual_seed(SEED + 1)
    prompts = torch.randint(0, cfg.vocab, (B, PROMPT), generator=gen,
                            device="cuda")
    plan = ServePlan(arch=cfg, wire="quantize_int8:physical", max_batch=B,
                     max_len=PROMPT + GEN + 1, fused_entry=True)
    runs: dict = {}
    for name in ("gspmd", "ep", "gspmd"):
        sess = ServeSession(plan, params, device="cuda", model=models[name])
        sess.generate(prompts, 2)                # warmup
        torch.cuda.synchronize()
        ops.reset_launches()
        mesh.counts.clear()
        t0 = time.perf_counter()
        tok0 = sess.prefill(prompts)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        at_prefill = dict(mesh.counts)
        t0 = time.perf_counter()
        rest = sess.decode(tok0, GEN - 1)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / (GEN - 1) * 1e3
        launches = ops.launch_counts()
        counts = dict(mesh.counts)
        hold_launches(launches, gspmd_launches)
        reduces = n_moe if name == "ep" else 0
        if at_prefill != ({"all_reduce": reduces} if reduces else {}) or \
                counts != ({"all_reduce": reduces * GEN} if reduces else {}):
            fail(f"{name}: collective calls {at_prefill} at prefill, "
                 f"{counts} over the run; expected {reduces} all_reduce a "
                 "forward")
        runs.setdefault(name, []).append(
            (torch.cat([tok0, rest], dim=1), sess.bytes_per_token(),
             t_prefill, step_ms, launches))
        del sess
    toks, per_tok = runs["gspmd"][0][:2]
    for name, rs in runs.items():
        for r in rs:
            if not torch.equal(r[0], toks) or r[1] != per_tok:
                fail(f"{name}: tokens or bytes per token ({r[1]}) differ "
                     f"from the GSPMD path's ({per_tok})")
    wire_bytes = (cfg.d_model + 4) + (cfg.vocab + 4)
    if per_tok != wire_bytes:
        fail(f"EP serving: {per_tok} wire bytes a token, not {wire_bytes}")
    ms = {name: [r[3] for r in rs] for name, rs in runs.items()}
    print(f"  tokens ({B}x{GEN}) and wire bytes ({per_tok} a token) bitwise "
          f"the GSPMD path's; launches exactly phase 3l's {gspmd_launches}; "
          f"all_reduce {n_moe} a forward ({n_moe * GEN} a run)")
    print(f"  decode ms a step (GSPMD, EP, GSPMD order): GSPMD "
          f"{ms['gspmd']}, EP {ms['ep']}; prefill s GSPMD "
          f"{[r[2] for r in runs['gspmd']]}, EP {[r[2] for r in runs['ep']]}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": runs["ep"][0][4], "wire_bytes_per_token": per_tok,
            "decode_step_ms": ms["ep"], "gspmd_decode_step_ms": ms["gspmd"],
            "prefill_s": [r[2] for r in runs["ep"]],
            "all_reduce_per_decode_step": n_moe}


def ep_grad(torch) -> dict:
    """Phase 3t (b): one Qwen3-30B-A3B MoE layer at full width (128
    experts of 768, top-8, d 2,048), fp32, T = CLI_B x CLI_S: the output
    and the gradient of x and of every parameter of the EP path over the
    one-rank mesh bitwise the single-device path's, both under
    deterministic algorithms (the dispatch's index backward accumulates
    without atomics)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn import moe as M
    from repro_torch.nn.module import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(EP_ARCH), dtype=torch.float32)
    mcfg = build_model(cfg).groups[-1].specs[0].moe
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    params = M.moe_init(gen, mcfg, "cuda")
    x = torch.randn((CLI_B, CLI_S, cfg.d_model), generator=gen,
                    device="cuda")
    ct = torch.randn(x.shape, generator=gen, device="cuda")
    drops = float(M.moe_apply(params, mcfg, x,
                              return_aux=True)[1]["drop_fraction"])
    out, ms = {}, {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, c in (("gspmd", mcfg),
                        ("ep", dataclasses.replace(mcfg, ep_axis="model"))):
            for _ in range(2):                   # the second call timed
                p = tree_map(lambda t: t.detach().clone().requires_grad_(),
                             params)
                xx = x.clone().requires_grad_()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = M.moe_apply(p, c, xx)
                (y * ct).sum().backward()
                torch.cuda.synchronize()
                ms[name] = (time.perf_counter() - t0) * 1e3
            out[name] = [y.detach(), xx.grad] + [t.grad for t in
                                                 tree_leaves(p)]
    finally:
        torch.use_deterministic_algorithms(False)
    bad = [i for i, (a, b) in enumerate(zip(out["gspmd"], out["ep"]))
           if not torch.equal(a, b)]
    if bad or len(out["ep"]) != len(out["gspmd"]):
        fail(f"EP gradient at D=1: tensors {bad} of (y, dx, the "
             "parameters' gradients) differ from the single-device path's")
    print(f"EP gradient at D=1: {cfg.name} MoE layer ({mcfg.n_experts} "
          f"experts of {mcfg.d_ff}, top-{mcfg.top_k}), fp32, x "
          f"{tuple(x.shape)}, drop_fraction {drops:.4f}: y, dx and the "
          f"{len(out['ep']) - 2} parameter gradients bitwise the "
          f"single-device path's; forward + backward {ms['gspmd']:.3f} ms "
          f"(single device), {ms['ep']:.3f} ms (EP), deterministic")
    del out, params
    torch.cuda.empty_cache()
    return {"ms": ms["ep"], "gspmd_ms": ms["gspmd"], "drop_fraction": drops}


def _kv_layer(torch, dtype):
    """qwen1_5_32b's attention in `dtype` with seeded weights and biases,
    and one seeded generator for the rows and inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn import attention as A

    attn = dataclasses.replace(
        build_model(get_config(KV_ARCH)).groups[0].specs[0].attn, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    params = A.gqa_init(gen, attn, "cuda")
    for name in ("wq", "wk", "wv"):
        b = params[name]["b"]
        b.copy_(torch.randn(b.shape, generator=gen, device="cuda"))
    return attn, params, gen


def _kv_steps(torch, attn, params, gen, caches: dict, check) -> dict:
    """KV_STEPS decode steps of every cache in `caches` (name -> (config,
    cache)) on the same seeded inputs; `check(step, outputs)` holds each
    step's outputs.  Returns each cache's ms a step (host clock around
    the synchronized step, median)."""
    from repro_torch.nn import attention as A

    times = {name: [] for name in caches}
    with torch.no_grad():
        for step in range(KV_STEPS):
            x = torch.randn((KV_B, 1, attn.d_model), generator=gen,
                            device="cuda").to(attn.dtype)
            ys = {}
            for name, (c, cache) in caches.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ys[name], _ = A.gqa_decode(params, c, x, cache)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
            check(step, ys)
    return {name: statistics.median(t) for name, t in times.items()}


def _rel_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def split_kv(torch) -> dict:
    """Phase 3t (c): the split-KV decode over the one-rank mesh against the
    native `gqa_decode` at qwen1_5_32b's width, fp32, batch KV_B, a
    KV_RING ring of seeded rows from KV_POS for KV_STEPS steps (the ring
    wraps): each step within KV_REL of the native output's largest
    value."""
    from repro_torch.nn import attention as A

    attn, params, gen = _kv_layer(torch, torch.float32)
    sharded = dataclasses.replace(attn, decode_kv_shard="model")
    native = A.gqa_init_cache(attn, KV_B, KV_RING, "cuda")
    split = A.gqa_init_cache(sharded, KV_B, KV_RING)
    for name in ("k", "v"):
        native[name].normal_(generator=gen)
        split[name].copy_(native[name])
    native["pos"] = split["pos"] = KV_POS
    errs = []

    def check(step, ys):
        errs.append(_rel_err(torch, ys["split"], ys["native"]))
        if errs[-1] > KV_REL:
            fail(f"split-KV step {step}: {errs[-1]:.3g} of the native "
                 f"output's largest value, above {KV_REL}")
    ms = _kv_steps(torch, attn, params, gen, {"native": (attn, native),
                                              "split": (sharded, split)},
                   check)
    ring_err = max(_rel_err(torch, split[n], native[n]) for n in "kv")
    if ring_err > KV_REL or not native["pos"] == split["pos"] == \
            KV_POS + KV_STEPS:
        fail(f"split-KV: the ring ({ring_err:.3g} of its largest value) or "
             f"pos ({split['pos']}) differs from the native cache's")
    print(f"split-KV at D=1: {KV_ARCH} attention (d {attn.d_model}, "
          f"{attn.n_heads}/{attn.n_kv_heads} heads of {attn.head_dim}, "
          f"qkv bias), fp32, batch {KV_B}, ring {KV_RING} from pos {KV_POS},"
          f" {KV_STEPS} steps across the wrap: each step within "
          f"{max(errs):.3g} of the native output's largest value (limit "
          f"{KV_REL}); the rings within {ring_err:.3g}; ms a step native {ms['native']:.3f},"
          f" split-KV {ms['split']:.3f}")
    del native, split
    torch.cuda.empty_cache()
    return {"ms": ms["split"], "native_ms": ms["native"],
            "max_rel_err": max(errs)}


def int8_kv(torch) -> dict:
    """Phase 3t (d): the int8 KV cache against the native one, the same
    layer in bf16 and the same ring and steps: its bytes exactly
    2·B·L·K·(hd + 4) (native 2·B·L·K·hd·2), each step within INT8_REL of
    the native output's largest value, and every row the step quantized
    (q and scale) bitwise `_quant_kv` of the same row on the CPU and in
    the ring at its slot."""
    from repro_torch.nn import attention as A

    attn, params, gen = _kv_layer(torch, torch.bfloat16)
    q8 = dataclasses.replace(attn, kv_cache_dtype="int8")
    native = A.gqa_init_cache(attn, KV_B, KV_RING, "cuda")
    quant = A.gqa_init_cache(q8, KV_B, KV_RING, "cuda")
    K, hd = attn.n_kv_heads, attn.head_dim

    def nbytes(c):
        return sum(t.numel() * t.element_size() for t in c.values()
                   if isinstance(t, torch.Tensor))
    want = (2 * KV_B * KV_RING * K * (hd + 4), 2 * KV_B * KV_RING * K * hd * 2)
    if (nbytes(quant), nbytes(native)) != want:
        fail(f"int8 cache {nbytes(quant)} B, native {nbytes(native)} B; "
             f"expected {want}")
    for name in ("k", "v"):
        rows = torch.randn(native[name].shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
        native[name].copy_(rows)
        q, scale = A._quant_kv(rows)
        quant[name].copy_(q)
        quant[name + "_scale"].copy_(scale)
        del rows, q, scale
    native["pos"] = quant["pos"] = KV_POS
    quantized, errs = [], []

    def capture(fn):
        def kept(t):
            q, scale = fn(t)
            if t.shape[1] == 1:                  # a decode step's row
                quantized.append((t, q, scale))
            return q, scale
        return kept

    def check(step, ys):
        errs.append(_rel_err(torch, ys["int8"], ys["native"]))
        if errs[-1] > INT8_REL:
            fail(f"int8 KV step {step}: {errs[-1]:.3g} of the native "
                 f"output's largest value, above {INT8_REL}")
        slot = (KV_POS + step) % KV_RING
        for name, (t, q, scale) in zip(("k", "v"), quantized):
            q_cpu, s_cpu = A._quant_kv(t.cpu())
            if not (torch.equal(q.cpu(), q_cpu)
                    and torch.equal(scale.cpu(), s_cpu)
                    and torch.equal(quant[name][:, slot], q[:, 0])
                    and torch.equal(quant[name + "_scale"][:, slot],
                                    scale[:, 0])):
                fail(f"int8 KV step {step}: the {name} row's q or scale "
                     "differs from the CPU's quantization or the ring's")
        quantized.clear()
    with patched({("repro_torch.nn.attention", "_quant_kv"): capture}):
        ms = _kv_steps(torch, attn, params, gen,
                       {"native": (attn, native), "int8": (q8, quant)},
                       check)
    print(f"int8 KV cache: {KV_ARCH} attention, bf16, batch {KV_B}, ring "
          f"{KV_RING} from pos {KV_POS}, {KV_STEPS} steps: {want[0]} B "
          f"against native {want[1]} B; each step within {max(errs):.4f} "
          f"of the native output's largest value (limit {INT8_REL}); "
          f"every decoded row's q and scale bitwise the CPU's and the "
          f"ring's; ms a step native {ms['native']:.3f}, int8 "
          f"{ms['int8']:.3f}")
    del native, quant
    torch.cuda.empty_cache()
    return {"ms": ms["int8"], "native_ms": ms["native"],
            "max_rel_err": max(errs), "cache_bytes": want[0],
            "native_cache_bytes": want[1]}


def t_cli(torch, arch) -> dict:
    """Phase 3t (e): one training CLI run (`cli_path`) at `T_RUNS`'s
    depth, through expandable segments, the peak leaving FAM_FREE_GIB
    free."""
    cfg, clients, cut = t_config(arch)
    print(f"{cfg.name} training: {cfg.n_layers} layers (cut {cut}), "
          f"{clients} client{'s' * (clients > 1)}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        res = cli_path(torch, t_path(arch), arch, t_argv(clients),
                       CLI_STEPS, cfg)
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    if total - res["peak_gib"] < FAM_FREE_GIB:
        fail(f"{t_path(arch)}: peak {res['peak_gib']:.2f} GiB leaves less "
             f"than {FAM_FREE_GIB} GiB of {total:.2f} free")
    print(f"  {cfg.name}: depth {cfg.n_layers}, {res['round_ms']:.3f} ms a "
          f"step, peak {res['peak_gib']:.2f} GiB of {total:.2f}")
    return {**res, "layers": cfg.n_layers, "cut": cut, "clients": clients}


def sharded_phase(torch, gspmd_launches: dict) -> dict:
    """Phase 3t: (a) EP serving, (b) the EP gradient, (c) split-KV and (d)
    the int8 KV cache over a one-rank NCCL mesh
    (`make_mesh_compat((1, 1), ("data", "model"))`, destroyed at the end
    of the phase, failed or not), then (e) the MoE and new dense configs
    trained by the CLI.  Returns the kernel paths, (a) and (e)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.nn import dist as tdist

    out = {}
    try:
        mesh = make_mesh_compat((1, 1), ("data", "model"))
        tdist.set_mesh(mesh)
        out[EP_PATH] = ep_serving(torch, mesh, gspmd_launches)
        ep_grad(torch)
        split_kv(torch)
        int8_kv(torch)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for arch in T_RUNS:
        out[t_path(arch)] = t_cli(torch, arch)
    return out


# ---------------------------------------------------------------------------
# phase 3u: the long-context variant and the dry run's step functions
# ---------------------------------------------------------------------------

U_ARCH = "phi4_mini_3_8b"
U_PATH = "phi4_mini_3_8b_long_context_serving"
U_TRAIN_PATH = "phi4_mini_3_8b_dryrun_train_step"
# (a): a prompt past the 8,192-row window, then greedy decode over the
# ring, which has wrapped; a prompt the window does not bind; the
# long_500k cache's length
U_PROMPT, U_DECODE, U_SHORT, U_LONG_LEN = 12288, 32, 8192, 524288
# the long-context model against the normal one where the window does not
# bind: logits within this share of the top logit (phase 3o's bound; the
# window-mode kernel may tile the keys in another order)
U_REL = BAT_SOLO_REL
# the reduced card == CPU check: 2 layers at full width (fp32), a 64-row
# window, a prompt past it and decode steps that wrap the ring again
U_REDUCED = dict(n_layers=2, long_window=64)
U_RED_PROMPT, U_RED_DECODE = 96, 48
# (b): the dry run's train step at B=1 x S=4096, 3 AdamW(3e-4) steps at the
# deepest depth leaving FAM_FREE_GIB free; remat against none at 4 layers
U_TRAIN_B, U_TRAIN_S, U_TRAIN_STEPS, U_REMAT_LAYERS = 1, 4096, 3, 4
# the depths whose one-step peaks set the line the depth is read off:
# deep enough that AdamW's update, not the float32 log-softmax over the
# 200,064 logits, sets the peak (at 1 and 2 layers it is the logits, and
# their slope predicted 28 layers where 28 ran out of memory)
U_PROBE = (8, 12)


def _ring_bytes(caches) -> int:
    from repro_torch.nn.module import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(caches)
               if hasattr(t, "numel"))


def _greedy(torch, model, params, tokens, decode: int, device):
    """Prefill `tokens` (1, S) into a fresh cache, then `decode` greedy
    steps: (logits of the prefill, the 1 + decode tokens, caches)."""
    from repro_torch.serve import greedy_decode_scan

    caches = model.init_cache(1, tokens.shape[1] + decode + 1, device)
    with torch.no_grad():
        logits, caches = model.prefill(params, {"tokens": tokens}, caches)
        tok0 = torch.argmax(logits[:, -1], -1)[:, None]
        rest, caches = greedy_decode_scan(model, params, caches, tok0, decode)
    return logits, torch.cat([tok0, rest], 1), caches


def long_context_path(torch) -> dict:
    """Phase 3u (a): phi4-mini whole in its long-context variant (bf16,
    window 8,192), a 12,288-token prompt and 32 greedy steps over the
    wrapped ring; the long_500k ring's bytes; the window not binding at
    8,192 tokens."""
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    cfg = _config(U_ARCH)
    W, L = cfg.long_window, cfg.n_layers
    model, normal = build_model(cfg, long_context=True), build_model(cfg)
    ring = model.init_cache(1, U_LONG_LEN, "meta")
    nb, nb_full = _ring_bytes(ring), _ring_bytes(normal.init_cache(
        1, U_LONG_LEN, "meta"))
    want = 2 * L * W * cfg.n_kv_heads * cfg.resolved_head_dim * 2
    print(f"long-context {cfg.name}: window {W}; the long_500k cache (B=1, "
          f"max_len {U_LONG_LEN}) is a ring of {ring[0][0]['0']['k'].shape[1]}"
          f" rows, {nb:,} B in bf16 ({nb_full // nb}x as large without the "
          "window)")
    if ring[0][0]["0"]["k"].shape[1] != W or nb != want \
            or nb != 1_073_741_824 or nb_full != 64 * nb:
        fail(f"long_500k ring: {nb} B ({nb_full} without the window), "
             f"expected {want} = 1,073,741,824 and 64x that")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = normal.init(gen, "cuda")        # both variants take them
    gen.manual_seed(SEED + 1)
    prompt = torch.randint(0, LM_DATA_VOCAB, (1, U_PROMPT), generator=gen,
                           device="cuda")
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    logits, toks, caches = _greedy(torch, model, params, prompt, U_DECODE,
                                   "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    hold_launches(launches, {**NO_OTHER_KERNEL, "wire_quant": 0,
                             "wire_dequant": 0, "ssd_scan": 0,
                             "rmsnorm_bwd": 0,
                             "rmsnorm": (2 * L + 1) * (1 + U_DECODE),
                             "flash_attention": L})
    c0 = caches[0][0]["0"]
    if c0["k"].shape[1] != W or c0["pos"] != U_PROMPT + U_DECODE:
        fail(f"ring after decode: {c0['k'].shape[1]} rows at pos "
             f"{c0['pos']}")
    if not bool(torch.isfinite(logits[:, -1]).all()) or not bool(
            ((toks >= 0) & (toks < cfg.vocab)).all()):
        fail("long-context prefill: non-finite logits or tokens outside "
             "the vocabulary")
    print(f"  prompt {U_PROMPT} + {U_DECODE} greedy steps in {wall:.3f} s "
          f"(flash {L} launches in window mode, rmsnorm "
          f"{launches['rmsnorm']}), ring wrapped to pos {c0['pos']}, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; tokens "
          f"{toks[0, :8].tolist()}...")
    del logits, caches
    torch.cuda.empty_cache()

    short = prompt[:, :U_SHORT]
    lg_l, tok_l, _ = _greedy(torch, model, params, short, 0, "cuda")
    lg_n, tok_n, _ = _greedy(torch, normal, params, short, 0, "cuda")
    rel = ((lg_l.float() - lg_n.float()).abs().max()
           / lg_n.float().abs().max()).item()
    print(f"  window not binding at {U_SHORT} tokens: first token "
          f"{tok_l[0, 0].item()} (normal model {tok_n[0, 0].item()}), "
          f"prefill logits {'bitwise equal' if torch.equal(lg_l, lg_n) else ''}"
          f" within {rel:.3e} of the top logit ({U_REL})")
    if not torch.equal(tok_l, tok_n) or rel > U_REL:
        fail("long-context and normal models disagree where the window "
             f"does not bind: tokens {tok_l.tolist()} vs {tok_n.tolist()}, "
             f"logits {rel:.3e} of the top")
    del params, lg_l, lg_n
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "ring_bytes_long_500k": nb,
            "prefill_and_decode_s": wall}


def reduced_long_against_cpu(torch):
    """Phase 3u (a): phi4-mini at 2 layers, full width, fp32, window 64,
    a 96-token prompt and 48 greedy steps (the ring wraps at prefill and
    again in decode): the card's tokens equal the CPU's plain path's."""
    from repro_torch.models import build_model
    from repro_torch.nn.module import tree_map

    cfg = dataclasses.replace(_config(U_ARCH), dtype=torch.float32,
                              **U_REDUCED)
    model = build_model(cfg, long_context=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = model.init(gen, "cuda")
    prompt = torch.randint(0, LM_DATA_VOCAB, (1, U_RED_PROMPT),
                           generator=gen, device="cuda")
    _, card, _ = _greedy(torch, model, params, prompt, U_RED_DECODE, "cuda")
    params = tree_map(lambda t: t.cpu(), params)
    _, cpu, _ = _greedy(torch, model, params, prompt.cpu(), U_RED_DECODE,
                        "cpu")
    if not torch.equal(card.cpu(), cpu):
        fail(f"reduced long-context model: card tokens {card.tolist()} != "
             f"CPU tokens {cpu.tolist()}")
    print(f"reduced long-context phi4-mini (2 layers, full width, window "
          f"{cfg.long_window}), card == CPU over {U_RED_PROMPT} + "
          f"{U_RED_DECODE} tokens: {cpu[0, :12].tolist()}...")


def _u_train(torch, cfg, mesh, steps: int, gen_seed: int = SEED):
    """The dry run's train step (`launch.dryrun.build_train_step`: the
    loss with remat, its gradient, clip_by_global_norm(1.0), AdamW(3e-4))
    on `cfg` at B=1 x S=4096, its params laid out by `param_shardings`
    through `distribute_tensor` on the one-rank mesh: (losses, peak
    bytes, the locals (params, opt state, batch), the model)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import optim
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import build_model
    from repro_torch.nn.module import tree_leaves, tree_map

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(gen_seed)
    params = model.init(gen, "cuda")
    specs = meshlib.spec_leaves(meshlib.param_pspecs(params, mesh))
    shards = meshlib.param_shardings(params, mesh)
    it = iter(specs)

    def place(t, sharding):
        local = distribute_tensor(t, *sharding).to_local()
        want = meshlib.local_shape(tuple(t.shape), next(it), mesh)
        if tuple(local.shape) != want:
            fail(f"distribute_tensor: local shape {tuple(local.shape)} != "
                 f"{want}")
        return local
    params = tree_map(place, params, shards)
    opt = optim.adamw(3e-4)
    opt_state = opt.init(params)
    batch = lm_batch(gen, U_TRAIN_B, U_TRAIN_S, LM_DATA_VOCAB)
    step = dryrun.build_train_step(model, opt)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss.item())
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for t in
               tree_leaves((params, opt_state, batch)))
    return losses, torch.cuda.max_memory_allocated(), held, \
        (model, params, batch)


def dryrun_steps(torch) -> dict:
    """Phase 3u (b): the dry run's train, prefill and serve steps for
    real, on a (1, 1) ("data", "model") `DeviceMesh` over a one-rank NCCL
    group (destroyed at the end, failed or not)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import InputShape
    from repro_torch.core.split import _grads, _leaf_params
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build_model
    from repro_torch.nn.module import tree_leaves, tree_paths

    full = _config(U_ARCH)
    L_full = full.n_layers
    total = torch.cuda.get_device_properties(0).total_memory
    room = total - FAM_FREE_GIB * 2 ** 30
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        make_mesh_compat((1, 1), ("data", "model"))   # the NCCL group
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        # the depth: one step at U_PROBE layers each, where AdamW's update
        # sets the peak, extrapolated linearly; then one layer less at a
        # time until the counted run leaves FAM_FREE_GIB free
        peaks = {n: _u_train(torch, dataclasses.replace(full, n_layers=n),
                             mesh, 1)[1] for n in U_PROBE}
        lo, hi = U_PROBE
        per_layer = (peaks[hi] - peaks[lo]) / (hi - lo)
        n = min(L_full, int(lo + (room - peaks[lo]) // per_layer))
        print(f"dry-run train step ({full.name}, B={U_TRAIN_B} x "
              f"S={U_TRAIN_S}, bf16, AdamW, remat): peak "
              f"{peaks[lo] / 2**30:.2f} GiB at {lo} layers, "
              f"{peaks[hi] / 2**30:.2f} at {hi}, so {n} of {L_full} layers "
              f"leave {FAM_FREE_GIB} GiB free")
        while True:
            cfg = dataclasses.replace(full, n_layers=n)
            ops.reset_launches()
            t0 = time.perf_counter()
            try:
                losses, peak, held, run = _u_train(torch, cfg, mesh,
                                                   U_TRAIN_STEPS)
            except torch.OutOfMemoryError:
                peak = None
            if peak is not None and peak <= room:
                break
            run = None            # the failed run's tensors go first
            print(f"  {n} layers: " + ("out of memory" if peak is None
                                       else f"peak {peak / 2**30:.2f} GiB")
                  + f", leaving less than {FAM_FREE_GIB} GiB; one less")
            n -= 1
        wall = time.perf_counter() - t0
        model, params, batch = run
        launches = ops.launch_counts()
        S = U_TRAIN_STEPS
        hold_launches(launches, {**NO_OTHER_KERNEL, "wire_quant": 0,
                                 "wire_dequant": 0, "ssd_scan": 0,
                                 "rmsnorm": S * (4 * n + 1),
                                 "rmsnorm_bwd": S * 2 * (2 * n + 1),
                                 "flash_attention": S * 2 * n})
        if not losses[-1] < losses[0] or not all(map(math.isfinite,
                                                     losses)):
            fail(f"dry-run train step: losses {losses} do not fall")
        _, _, nbytes = dryrun.combo_args(
            cfg, InputShape("train_1x4k", U_TRAIN_S, U_TRAIN_B, "train"),
            mesh)
        args = nbytes["params"] + nbytes["opt_state"] + nbytes["batch"]
        print(f"  {n} layers: losses {losses}, {wall:.2f} s for "
              f"{S} steps with init, peak {peak / 2**30:.2f} GiB of "
              f"{total / 2**30:.2f}; launches {launches}; the dry run's "
              f"per_device_bytes.arguments at (1, 1) {args:,} B, held "
              f"{held:,} B")
        if args != held:
            fail(f"dry run's arguments {args} B != the {held} B held")

        prefill = dryrun.build_prefill_step(model)
        serve = dryrun.build_serve_step(model)
        with torch.no_grad():
            nxt = prefill(params, {"tokens": batch["tokens"]})
            caches = model.init_cache(1, U_TRAIN_S + 1, "cuda")
            model.prefill(params, {"tokens": batch["tokens"]}, caches)
            tok = torch.argmax(nxt[:, -1], -1)[:, None]
            logits, caches = serve(params, tok, caches)
        torch.cuda.synchronize()
        if tuple(nxt.shape) != (1, 1, full.vocab) or tuple(
                logits.shape) != (1, 1, full.vocab) or not bool(
                torch.isfinite(logits).all() & torch.isfinite(nxt).all()):
            fail(f"prefill / serve steps: {tuple(nxt.shape)}, "
                 f"{tuple(logits.shape)}")
        print(f"  prefill step -> next-token logits {tuple(nxt.shape)}, "
              f"serve step -> {tuple(logits.shape)} at pos "
              f"{caches[0][0]['0']['pos']}, both finite")
        del model, params, batch, caches, nxt, logits

        # remat against none at U_REMAT_LAYERS: the same arithmetic
        cfg4 = dataclasses.replace(full, n_layers=U_REMAT_LAYERS)
        model4 = build_model(cfg4)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        p4 = model4.init(gen, "cuda")
        b4 = lm_batch(gen, U_TRAIN_B, U_TRAIN_S, LM_DATA_VOCAB)
        torch.use_deterministic_algorithms(True)
        try:
            out = {}
            for remat in (True, False):
                p = _leaf_params(p4)
                loss = model4.loss(p, b4, remat=remat)
                out[remat] = (loss.detach(), tree_leaves(_grads(loss, p)))
        finally:
            torch.use_deterministic_algorithms(False)
        differ = [("/".join(path), (a.float() - b.float()).abs().max().item())
                  for path, a, b in zip(tree_paths(p4), out[True][1],
                                        out[False][1]) if not torch.equal(a, b)]
        same = torch.equal(out[True][0], out[False][0]) and not differ
        print(f"  remat vs none at {U_REMAT_LAYERS} layers: loss "
              f"{out[True][0].item()} / {out[False][0].item()}, "
              f"{len(out[True][1])} gradients "
              + ("all bitwise equal" if same else f"differ at {differ}"))
        if not same:
            fail(f"remat changed the loss or the gradients: {differ}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    return {"launches": launches, "layers": n, "losses": losses,
            "peak_gib": peak / 2 ** 30, "arguments_bytes": args}


def long_context_phase(torch) -> dict:
    """Phase 3u: (a) long-context serving, its reduced card == CPU check,
    then (b) the dry run's step functions."""
    out = {U_PATH: long_context_path(torch)}
    reduced_long_against_cpu(torch)
    out[U_TRAIN_PATH] = dryrun_steps(torch)
    return out


# ---------------------------------------------------------------------------

def main():
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("run from the root of a checkout: src/repro_torch not found")
    # phase 3j's physical == fake check runs under deterministic
    # algorithms, whose cuBLAS needs this set before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    phase_s: dict = {}

    def phase(name: str, fn, *args):
        """`fn(*args)`, its wall seconds printed on a line of its own."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        print(f"phase {name}: {phase_s[name]:.1f} s wall")
        return out

    # phase 1: the card and the build
    card = card_line()
    print(f"card: {card}")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    seconds = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall, "
          f"per library {seconds}")
    for name, log in build.build_logs.items():
        fn = ""
        for line in log.splitlines():
            if "Function properties for" in line:   # the mangled kernel
                fn = line.split("for", 1)[1].strip()
            elif "registers" in line or "spill" in line:
                print(f"  {name} {fn}: {line.strip()}")
    phase_s["1"] = time.perf_counter() - t_start
    print(f"phase 1: {phase_s['1']:.1f} s wall")

    # phase 2: kernels against their plain versions
    def check_kernels():
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1234)
        return (check_wire(torch, gen), check_splitcat(torch, gen),
                check_splitcat_dense(torch, gen), check_rmsnorm(torch),
                check_ssd(torch), check_flash(torch), check_flash_long(torch),
                check_grads(torch))
    ((wire, payloads), (sc_err, (t, t_plain, t_lib, b)),
     (dn_err, (td, td_plain, td_lib, bd)), (rn_err, rn_t), (ssd_err, ssd_t),
     (fa_err, fa_t), fa_long, (bwd, bwd_bf16)) = phase("2", check_kernels)

    # phase 3: each main path, then its small-input reference check
    run = phase("3", main_path, torch)
    phase("3 reduced", reduced_against_cpu, torch)
    train = phase("3b", train_path, torch)
    phase("3b reduced", reduced_branch_against_cpu, torch, "vertical")
    ssm = phase("3c", ssm_path, torch)
    phase("3c reduced", reduced_ssm_against_cpu, torch)
    hybrid = phase("3d", hybrid_path, torch)
    phase("3d reduced", reduced_hybrid_against_cpu, torch)
    turn = {}
    for mode in TURN_KINDS:
        turn[mode] = phase(f"3e/3f {mode}", turn_path, torch, mode)
        phase(f"3e/3f {mode} reduced", reduced_turn_against_cpu, torch, mode)
    branch = {}
    for mode in ("multitask", "extended_vanilla"):
        branch[mode] = phase(f"3g {mode}", branch_path, torch, mode)
        phase(f"3g {mode} reduced", reduced_branch_against_cpu, torch, mode)
    baseline = {}
    for mode in BASELINES:
        baseline[mode] = phase(f"3h {mode}", baseline_path, torch, mode)
        phase(f"3h {mode} reduced", reduced_baseline_against_cpu, torch,
              mode)
    table1(turn["vanilla"], baseline["fedavg"], baseline["large_batch"])
    sched = phase("3i", schedules_phase, torch,
                  {"vertical": train, **turn, **branch, **baseline})
    lm = phase("3j", lm_phase, torch)
    cli = phase("3k", cli_phase, torch)
    resnet = phase("3k resnet", resnet_path, torch)
    phase("3k resnet reduced", reduced_resnet_against_cpu, torch)
    moe = {}
    for letter, arch in zip("lm", MOE_RUNS):
        moe[arch] = phase(f"3{letter}", moe_path, torch, arch)
        phase(f"3{letter} reduced", reduced_moe_against_cpu, torch, arch)
    mono = phase("3n", mono_path, torch)
    bat = phase("3o", batcher_path, torch)
    phase("3o reduced", reduced_batcher_against_cpu, torch)
    fig3 = phase("3p tables", paper_tables_path, torch)
    examples = phase("3p examples", examples_path, torch)
    vlm = phase("3q", vlm_phase, torch)
    phase("3q reduced", reduced_vlm_against_cpu, torch)
    encdec = phase("3r", encdec_phase, torch)
    phase("3r reduced", reduced_whisper_against_cpu, torch)
    fleet = phase("3s", fleet_phase, torch)
    sharded = phase("3t", sharded_phase, torch,
                    moe[EP_ARCH]["launches"])
    longctx = phase("3u", long_context_phase, torch)

    # the wire launches per payload add up to what each path was held to
    paths = (("serving", run), ("training", train), ("ssm_serving", ssm),
             ("hybrid_serving", hybrid),
             *((path_name(m), r) for m, r in turn.items()),
             *((path_name(m), r) for m, r in branch.items()),
             *((path_name(m), r) for m, r in baseline.items()),
             *((path_name(m, sc), r) for (m, sc), r in sched.items()),
             *((_lm_path_name(a, m, sc), r) for (a, m, sc), r in lm.items()),
             *cli.items(), ("resnet_vanilla_training", resnet),
             *((MOE_RUNS[arch].path, r) for arch, r in moe.items()),
             *mono.items(), (BAT_PATH, bat), (FIG3_PATH, fig3),
             *examples.items(), *vlm.items(), *encdec.items(),
             *fleet.items(), *sharded.items(), *longctx.items())
    for path, res in paths:
        for i, name in enumerate(("wire_quant", "wire_dequant")):
            want = sum(p[-1][i] for p in payloads if p[0] == path)
            if res["launches"][name] != want:
                fail(f"{path}: {res['launches'][name]} {name} launches, "
                     f"but its payloads in phase 2 add up to {want}")
    print("wire launches by payload add up to each path's count")

    # phase 4: the record; launches are the main paths' together
    kq = wire[((4, 1, 200064), torch.bfloat16)]
    fa = fa_t["RecurrentGemma-2B prefill"]
    fa_mla = fa_t["DeepSeek-V2 MLA prefill"]
    fa_enc = fa_t[WHISPER_ENC]
    src = "src/repro_torch/kernels/csrc/"
    by_path = {name: {path: res["launches"][name] for path, res in paths}
               for name in run["launches"]}
    n = {name: sum(v.values()) for name, v in by_path.items()}
    kernels = [
        {"name": "wire_quant", "route": "cuda", "source": src + "wire_quant.cu",
         "replaces": "src/repro/kernels/wire_quant.py:57",
         "launches": n["wire_quant"], "max_abs_err": 0.0,
         "ms": kq[0], "plain_ms": kq[1], "bound_ms": kq[2][0],
         "bound_by": kq[2][1], "library_ms": None},
        {"name": "wire_dequant", "route": "cuda",
         "source": src + "wire_quant.cu",
         "replaces": "src/repro/kernels/wire_quant.py:89",
         "launches": n["wire_dequant"], "max_abs_err": 0.0,
         "ms": kq[3], "plain_ms": kq[4], "bound_ms": kq[5][0],
         "bound_by": kq[5][1], "library_ms": kq[6]},
        {"name": "splitcat_linear_q8", "route": "cuda",
         "source": src + "splitcat_linear_q8.cu",
         "replaces": "src/repro/kernels/splitcat_linear.py:62",
         "launches": n["splitcat_linear_q8"],
         "max_abs_err": sc_err, "ms": t, "plain_ms": t_plain,
         "bound_ms": b[0], "bound_by": b[1], "library_ms": t_lib},
        {"name": "splitcat_linear", "route": "cuda",
         "source": src + "splitcat_linear.cu",
         "replaces": "src/repro/kernels/splitcat_linear.py:128",
         "launches": n["splitcat_linear"], "max_abs_err": dn_err,
         "ms": td, "plain_ms": td_plain, "bound_ms": bd[0],
         "bound_by": bd[1], "library_ms": td_lib},
        {"name": "rmsnorm", "route": "cuda", "source": src + "rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:24",
         "launches": n["rmsnorm"], "max_abs_err": rn_err,
         "ms": rn_t[0], "plain_ms": rn_t[1], "bound_ms": rn_t[3][0],
         "bound_by": rn_t[3][1], "library_ms": rn_t[2]},
        {"name": "ssd_scan", "route": "cuda", "source": src + "ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:66",
         "launches": n["ssd_scan"], "max_abs_err": ssd_err,
         "ms": ssd_t[0], "plain_ms": ssd_t[1], "bound_ms": ssd_t[3][0],
         "bound_by": ssd_t[3][1], "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:81",
         "launches": n["flash_attention"], "max_abs_err": fa_err,
         "ms": fa[0], "plain_ms": fa[1], "bound_ms": fa[3][0],
         "bound_by": fa[3][1], "library_ms": fa[2],
         "mla_prefill": dict(zip(
             ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "max_abs_err"),
             (*fa_mla[:3], *fa_mla[3], fa_mla[4]))),
         "non_causal_whisper_encoder": dict(zip(
             ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "max_abs_err"),
             (*fa_enc[:3], *fa_enc[3], fa_enc[4]))),
         "long_context_window_8192": dict(zip(
             ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
              "max_abs_err"),
             (*fa_long[:3], *fa_long[3], fa_long[4])))},
    ]
    for k in kernels:
        k["launches_by_path"] = by_path[k["name"]]
        if k["name"] in bwd:     # the training gradient (phase 2)
            for pre, times in (("backward", bwd), ("backward_bf16",
                                                   bwd_bf16)):
                t_bwd, t_plain, t_lib, t_k, bd, ws = times[k["name"]]
                k.update({f"{pre}_ms": t_bwd, f"{pre}_plain_ms": t_plain,
                          f"{pre}_library_ms": t_lib})
                if t_k is not None:     # rmsnorm's backward kernels
                    k.update({f"{pre}_kernel_ms": t_k,
                              f"{pre}_kernel_bound_ms": bd[0],
                              f"{pre}_kernel_bound_by": bd[1],
                              f"{pre}_kernel_workspace_bytes": ws})
    rn = next(k for k in kernels if k["name"] == "rmsnorm")
    rn["backward_launches"] = n["rmsnorm_bwd"]
    rn["backward_launches_by_path"] = by_path["rmsnorm_bwd"]
    print("kernel times above are at the main paths' shapes: wire_quant "
          "and wire_dequant on the (4,1,200064) bf16 logits, "
          "splitcat_linear_q8 on the (4,1,3072) x (3072,5120) bf16 entry, "
          "splitcat_linear on the (512,512)|(512,512) x (1024,10)+b fp32 "
          "evaluation entry, rmsnorm on the Mamba2 prefill's (4,512,768) "
          "bf16 block norm, ssd_scan on the Mamba2 prefill's "
          "(4,512,24,64) bf16 scan from a zero state, flash_attention on "
          "the RecurrentGemma-2B prefill's q (4,4096,10,256), k/v "
          "(4,4096,1,256) bf16, window 2048 (mla_prefill: DeepSeek-V2's q/k "
          "(4,128,128,192), v (4,128,128,128) bf16, causal; "
          "non_causal_whisper_encoder: Whisper-base's encoder q/k/v "
          "(4,1500,8,64) bf16, non-causal; long_context_window_8192: "
          "phase 3u's phi4-mini q (1,12288,24,128), k/v (1,12288,8,128) "
          "bf16, window 8192); the backward "
          "times of "
          "rmsnorm, ssd_scan and flash_attention at the LM training "
          "shapes (4,512,768), x (4,512,24,64) from a zero state and q "
          "(4,512,24,128) causal, fp32, and (backward_bf16_*) at the "
          "CLI's (8,512,768), x (8,512,24,64) and q (8,512,10,256) "
          "windowed, bf16 (backward_*_ms: the Function's backward from "
          "CUDA events; rmsnorm's backward_*_kernel_ms: its "
          f"{RMS_BWD_KERNELS} backward kernels alone, from CUDA-graph "
          "replays with x and g cold in L2, beside a bound over the "
          "function's own bytes; _kernel_workspace_bytes: the fp32 "
          "partial-dscale rows they write and read on top)")
    print("serving path: " + json.dumps(
        {k: v for k, v in run.items() if k != "launches"}))
    print("training path: " + json.dumps(
        {k: v for k, v in train.items() if k != "launches"}))
    print("SSM serving path: " + json.dumps(
        {k: v for k, v in ssm.items() if k != "launches"}))
    print("hybrid serving path: " + json.dumps(
        {k: v for k, v in hybrid.items() if k != "launches"}))
    for path, res in paths[4:]:
        print(f"{path.replace('_', ' ')} path: " + json.dumps(
            {k: v for k, v in res.items() if k != "launches"}))
    print(json.dumps({"kernels": kernels}))
    print(f"wall seconds by phase: {json.dumps(phase_s)}; total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
