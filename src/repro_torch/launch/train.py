"""End-to-end training entry point: argparse -> `repro_torch.api.Plan`
(port of `repro/launch/train.py`).

Every mode compiles through the one Plan/Session path:

  * monolithic   — Plan(mode="large_batch", n_clients=1): standard
    full-model training as the degenerate one-client sync-SGD round;
  * split        — Plan(mode="vanilla") over `lm_split_fns`: the paper's
    protocol, client segment + server segment, only the cut activation
    crossing the tiers.  --n-clients > 1 runs the round-robin (or
    SplitFed-parallel, or microbatch-pipelined) round;
  * fedavg / large_batch — the paper's comparison baselines over the
    whole model (`FullFns`).

--wire stacks cut middleware, e.g. `--wire quantize_int8:physical,
dp_noise:0.05`.  The flags, modes and the JSON summary (the last stdout
line, after an `eval acc/client` line) are the reference's, plus
--device: the run is on the GPU unless `--device cpu`.  `--fleet` shards
the clients over the ranks of a process group (`--fleet-devices`, default
the world size): every rank runs this script, as under `torchrun
--nproc-per-node D`, and rank 0 prints and writes the checkpoints; a run
of one process is a fleet of one rank.  `--fleet` with `--mode
monolithic` exits, as the reference's does.  A topology other than
vanilla, an architecture the port lacks and `--mode split` of a VLM or an
encoder-decoder model exit with a message naming ROADMAP.md (the
reference's split path crashes on both: it
never drops a VLM's patch positions from the logits, and its EncDec has
no `split_params`).  The batch of round r, client i comes from a
generator seeded from (0, r, i); the held-out batch from (0, steps +
1).  A VLM's batches carry `patch_embeds` (B, n_patches, vision_dim)
and an encoder-decoder model's `audio_feats` (B, n_audio_frames,
d_model), each `0.02 * normal` in the model's dtype from the batch's
generator, as the reference's do; Whisper's text is at most 448 tokens.

Examples:
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch mamba2_130m --steps 30 --mode split --n-clients 2 \\
        --seq 512 --wire quantize_int8:physical,dp_noise:0.05
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch phi4_mini_3_8b --reduced --steps 20 --mode split \\
        --n-clients 4 --wire quantize_int8 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch whisper_base --reduced --steps 3 --mode fedavg \\
        --n-clients 2 --device cpu
    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch mamba2_130m --reduced --steps 3 --mode split \\
        --n-clients 2 --schedule parallel --fleet --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable

import torch

from repro_torch import bridge
from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.api import (FleetSpec, FullFns, Plan, Session,
                             lm_split_fns, parse_wire)
from repro_torch.configs import get_config
from repro_torch.data import synthetic as syn
from repro_torch.device import resolve_device
from repro_torch.engine import tree_at
from repro_torch.models import build_model, text_len
from repro_torch.nn.module import mix_seed

@dataclasses.dataclass
class TrainRun:
    """What one `main` call trained: its JSON summary, the session (state,
    meter) and the per-round batches it drew."""
    summary: dict
    session: Session
    losses: list
    round_batches: Callable        # round index -> [batch] * n_clients


def _generator(device, *words: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix_seed(*words))


def build_plan(model, args) -> Plan:
    opt = optim.adamw(args.lr, weight_decay=0.01)
    fleet = (FleetSpec(n_devices=args.fleet_devices or None)
             if args.fleet else None)
    schedule = args.schedule if args.schedule == "pipelined" else None
    if args.mode == "monolithic":
        if fleet is not None:
            raise SystemExit("--fleet: monolithic training has no client "
                             "axis to shard (n_clients=1); use --mode "
                             "split/fedavg/large_batch with --n-clients")
        return Plan(mode="large_batch",
                    model=FullFns(init=model.init, apply=model.forward),
                    n_clients=1, optimizer=opt, clip_norm=1.0,
                    schedule=schedule, microbatches=args.microbatches)
    if args.mode in ("fedavg", "large_batch"):
        # only the pipelined schedule changes a baseline (each client's
        # gradient streamed as M microbatches); the others are its round
        return Plan(mode=args.mode,
                    model=FullFns(init=model.init, apply=model.forward),
                    n_clients=args.n_clients, optimizer=opt,
                    schedule=schedule, microbatches=args.microbatches,
                    local_steps=args.local_steps, fleet=fleet)
    cfg = model.cfg
    if cfg.family == "vlm" or cfg.encdec:
        raise SystemExit(
            f"--mode split: {cfg.name} ({cfg.family}) trains through the "
            "monolithic and baseline modes; its split path is not ported "
            "(the reference's crashes); see ROADMAP.md")
    if args.topology != "vanilla":
        raise SystemExit(
            f"--topology {args.topology}: the LM launch path exposes the "
            "vanilla cut only (apply_client/apply_server), as the "
            "reference's does.  Other topologies build a Plan over a "
            "SegModel or Branch directly; see ROADMAP.md.")
    try:
        wire = parse_wire(args.wire)
    except ValueError as e:
        raise SystemExit(str(e))
    return Plan(mode="vanilla", model=lm_split_fns(model, args.cut),
                cut=args.cut, n_clients=args.n_clients,
                schedule=args.schedule, microbatches=args.microbatches,
                optimizer=opt, wire=wire, fleet=fleet,
                clip_norm=1.0 if args.n_clients == 1 else None)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mode",
                    choices=["monolithic", "split", "fedavg", "large_batch"],
                    default="monolithic")
    ap.add_argument("--cut", type=int, default=-1)
    ap.add_argument("--n-clients", type=int, default=1)
    ap.add_argument("--schedule",
                    choices=["round_robin", "parallel", "pipelined"],
                    default="round_robin")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="pipelined schedule: split each client batch "
                         "into M chunks streamed through the cut")
    ap.add_argument("--topology",
                    choices=["vanilla", "u_shaped", "vertical", "multihop"],
                    default="vanilla")
    ap.add_argument("--wire", default="",
                    help="comma list: quantize_int8[:physical],"
                         "dp_noise:SIGMA,leakage_probe")
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--fleet", action="store_true",
                    help="shard the client axis over the ranks of a process "
                         "group (repro_torch.engine.fleet): launch one "
                         "process a rank, e.g. torchrun --nproc-per-node D")
    ap.add_argument("--fleet-devices", type=int, default=0,
                    help="client-axis size (0 = the group's world size)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def arch_config(args):
    """The `--arch` config, reduced under `--reduced`."""
    try:
        cfg = get_config(args.arch)
    except NotImplementedError as e:
        raise SystemExit(f"--arch {args.arch}: {e} (ROADMAP.md)")
    if args.reduced:
        # a hybrid model keeps two super-blocks, so the default cut falls
        # on the boundary between them (one super-block would put it
        # inside, which neither package can split)
        cfg = cfg.reduced(vocab=256, **({"n_layers": 2 * len(cfg.pattern)}
                                        if cfg.pattern else {}))
    return cfg


def _save_checkpoints(sess: Session, args):
    """The reference's files: a split run's clients (all stacked, or the
    one client) and server, else the global model, each LM tree in the
    reference's layout.  A fleet's state is gathered over the ranks (every
    rank calls this) and rank 0 writes."""
    state = sess.gather_state()
    if sess.rank != 0:
        return
    if sess.plan.mode == "vanilla":
        if args.n_clients > 1:
            ckpt.save(args.ckpt + ".clients",
                      bridge.lm_tree_to_ref(state["clients"], axis=1),
                      step=args.steps)
        else:
            ckpt.save(args.ckpt + ".client",
                      bridge.lm_tree_to_ref(tree_at(state["clients"], 0)),
                      step=args.steps)
        ckpt.save(args.ckpt + ".server",
                  bridge.lm_tree_to_ref(state["server"]), step=args.steps)
    else:
        ckpt.save(args.ckpt, bridge.lm_tree_to_ref(state["global"]),
                  step=args.steps)


def main(argv=None, *, cfg=None, data_vocab=None) -> TrainRun:
    """Parse `argv` (default: the command line), train, print the summary.
    Two overrides for a caller: `cfg` replaces the `--arch` config (to cut
    its depth), and `data_vocab` draws the batches' token ids below it
    (the model keeps its vocabulary; the CLI's own batches span it, as
    the reference's do)."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.n_clients < 1:
        ap.error("--n-clients must be >= 1")
    device = resolve_device(args.device)
    cfg = cfg or arch_config(args)
    if args.cut < 0:
        args.cut = min(cfg.default_cut, max(1, cfg.n_layers // 2))
    model = build_model(cfg)

    # an encoder-decoder model's text is capped (`text_len`); a VLM's
    # patches come on top of its --seq text tokens, as in the reference
    seq = text_len(cfg, args.seq) if cfg.encdec else args.seq

    def batch_fn(gen):
        b = syn.lm_batch(gen, args.batch, seq, data_vocab or cfg.vocab)
        if cfg.family == "vlm":
            b["patch_embeds"] = (0.02 * torch.randn(
                (args.batch, cfg.n_patches, cfg.vision_dim), generator=gen,
                device=gen.device)).to(cfg.dtype)
        if cfg.encdec:
            b["audio_feats"] = (0.02 * torch.randn(
                (args.batch, cfg.n_audio_frames, cfg.d_model), generator=gen,
                device=gen.device)).to(cfg.dtype)
        return b

    def round_batches(r):
        return [batch_fn(_generator(device, 0, r, i))
                for i in range(args.n_clients)]

    sess = build_plan(model, args).compile(device=device)
    sess.init(torch.Generator(device=device).manual_seed(0))

    talk = sess.rank == 0
    t0 = time.time()
    losses = sess.fit(round_batches, rounds=args.steps,
                      log_every=args.log_every if talk else 0)
    dt = time.time() - t0

    # eval over the whole client fleet: one client hides the spread once
    # clients diverge
    eval_batch = batch_fn(_generator(device, 0, args.steps + 1))
    eval_accs = [round(float(a), 4) for a in sess.evaluate_all(eval_batch)]
    if talk:
        print(f"eval acc/client: {eval_accs} (mean "
              f"{sum(eval_accs) / len(eval_accs):.4f})", flush=True)

    extra: dict = {}
    if sess.plan.mode == "vanilla":
        extra = {"n_clients": args.n_clients, "schedule": args.schedule,
                 "microbatches": args.microbatches,
                 "topology": args.topology,
                 "client_gb": [round(g, 6) for g in
                               sess.meter()["client_gb"]]}
        if args.wire:
            extra["wire"] = args.wire
            extra["wire_report"] = sess.wire_report(round_batches(0))
    if args.ckpt:
        _save_checkpoints(sess, args)

    summary = {"arch": cfg.name, "mode": args.mode,
               "steps": args.steps, "wall_s": round(dt, 1),
               "first_loss": losses[0], "final_loss": losses[-1],
               "eval_acc_per_client": eval_accs}
    summary.update(extra)
    if talk:
        print(json.dumps(summary), flush=True)
    return TrainRun(summary, sess, losses, round_batches)


if __name__ == "__main__":
    main()
