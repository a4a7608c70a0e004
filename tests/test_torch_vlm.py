"""The port's VLM family (InternVL2: the dense LM behind `vision_proj`)
against the JAX reference, on the CPU.

Reduced InternVL2-2B (2 layers, d_model 128, 4 query heads over 2 KV
heads of 32, 8 patches of 64, vocab 97, fp32), the reference's
parameters from PRNGKey(0) bridged over; prompts and patches are seeded
numpy arrays handed to both.  Split serving cuts at layer 1, and every
cache holds `MAX_LEN + n_patches` rows, as the reference's test sizes
them.

* `LM.forward` and `LM.loss` (logits at the text positions only), and
  the loss's gradient over the whole tree, `vision_proj` included;
* monolithic `prefill` (patches in front) + `greedy_decode_scan`:
  tokens, and the caches' cursor at n_patches + S;
* `ServeSession.generate(..., extra=)` over the dense, fake-int8 and
  physical-int8 wires: tokens and `WireRecord`s against the reference's
  `ServeSession`, physical == fake, monolithic == split over the dense
  wire; `prefill_cost(..., extra)` bytes, the patches' rows crossing
  with the prompt's;
* `Batcher.join(..., extra=)`: each tenant's stream and the bytes
  against the reference's `Batcher`;
* `input_specs`; the serve CLI's refusal (it builds no patch input); the
  training CLI's monolithic and fedavg runs with the reference CLI's
  JSON keys, and `--mode split` refused.

Values at rtol = atol = 1e-5 (the frameworks sum matmuls in other
orders); gradients at rtol 1e-4, atol 1e-5 x the leaf's largest (a
backward's long sums, as `tests/test_torch_lm_train.py` states); tokens,
records and bytes bitwise.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JINPUT_SHAPES
from repro.configs import get_config as jget_config
from repro.launch import train as jtrain
from repro.models import build_model as jbuild_model
from repro.models import input_specs as jinput_specs
from repro.serve import Batcher as JBatcher
from repro.serve import ServePlan as JServePlan
from repro.serve import ServeSession as JServeSession
from repro.serve import greedy_decode_scan as jgreedy
from repro_torch import bridge
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model, input_specs
from repro_torch.nn import module as tmod
from repro_torch.serve import (Batcher, ServePlan, ServeSession,
                               greedy_decode_scan)
from _torch_threads import one_torch_thread

one_torch_thread()

ARCH = "internvl2_2b"
B, S, GEN, MAX_LEN = 2, 7, 5, 14
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
WIRES = {"dense": "", "fake_q8": "quantize_int8",
         "physical_q8": "quantize_int8:physical"}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.fixture(scope="module")
def setup():
    """(jax cfg, jax model, jax params, port cfg, port model, port params,
    prompt, patches)"""
    cfg_j = jget_config(ARCH).reduced(vocab=97)
    mj = jbuild_model(cfg_j)
    pj = mj.init(jax.random.PRNGKey(0))
    cfg_t = get_config(ARCH).reduced(vocab=97)
    mt = build_model(cfg_t)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                cfg_t)
    prompt = np.random.default_rng(1).integers(0, 97, (B, S))
    patches = (0.02 * np.random.default_rng(2).standard_normal(
        (B, cfg_t.n_patches, cfg_t.vision_dim))).astype(np.float32)
    return cfg_j, mj, pj, cfg_t, mt, pt, prompt, patches


def test_forward_loss_and_grad_match_reference(setup):
    _, mj, pj, cfg_t, mt, pt, prompt, patches = setup
    assert tuple(pt["vision_proj"]["w"].shape) == (64, 128)
    assert tuple(pt["vision_proj"]["b"].shape) == (128,)
    labels = np.random.default_rng(3).integers(0, 97, (B, S))
    bj = {"tokens": jnp.asarray(prompt), "patch_embeds": jnp.asarray(patches),
          "labels": jnp.asarray(labels)}
    bt = {"tokens": torch.from_numpy(prompt),
          "patch_embeds": torch.from_numpy(patches),
          "labels": torch.from_numpy(labels)}
    logits = mt.forward(pt, bt)
    assert tuple(logits.shape) == (B, S, 97)          # text positions only
    _close(logits, mj.forward(pj, bj))
    lj, gj = jax.jit(jax.value_and_grad(lambda p: mj.loss(p, bj)))(pj)
    leaves = tmod.tree_map(lambda t: t.detach().clone().requires_grad_(), pt)
    lt = mt.loss(leaves, bt)
    lt.backward()
    _close(lt, lj)
    gt = bridge.params_to_numpy(tmod.tree_map(lambda t: t.grad, leaves))
    assert np.abs(gt["vision_proj"]["w"]).max() > 0
    for a, b in zip(jax.tree_util.tree_leaves(gt),
                    jax.tree_util.tree_leaves(gj), strict=True):
        b = np.asarray(b)
        np.testing.assert_allclose(
            a, b, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(float(np.abs(b).max()), 1e-30))


def _mono_j(mj, pj, cfg_j, prompt, patches):
    cache = mj.init_cache(B, MAX_LEN + cfg_j.n_patches)
    logits, cache = mj.prefill(pj, {"tokens": jnp.asarray(prompt),
                                    "patch_embeds": jnp.asarray(patches)},
                               cache)
    tok0 = jnp.argmax(logits[:, -1], -1)[:, None]
    rest, _ = jgreedy(mj, pj, cache, tok0, GEN - 1)
    return logits, np.asarray(jnp.concatenate([tok0, rest], 1))


def _mono_t(mt, pt, cfg_t, prompt, patches):
    cache = mt.init_cache(B, MAX_LEN + cfg_t.n_patches)
    logits, cache = mt.prefill(pt, {"tokens": torch.from_numpy(prompt),
                                    "patch_embeds": torch.from_numpy(patches)},
                               cache)
    assert cache[0][0]["0"]["pos"] == cfg_t.n_patches + S
    tok0 = torch.argmax(logits[:, -1], -1)[:, None]
    rest, _ = greedy_decode_scan(mt, pt, cache, tok0, GEN - 1)
    return logits, torch.cat([tok0, rest], 1).numpy()


def test_monolithic_prefill_and_decode_match_reference(setup):
    cfg_j, mj, pj, cfg_t, mt, pt, prompt, patches = setup
    lj, toks_j = _mono_j(mj, pj, cfg_j, prompt, patches)
    lt, toks_t = _mono_t(mt, pt, cfg_t, prompt, patches)
    assert tuple(lt.shape) == (B, S, 97)
    _close(lt, lj)
    np.testing.assert_array_equal(toks_t, toks_j)


def _sessions(setup, wire):
    cfg_j, _, pj, cfg_t, _, pt, _, _ = setup
    kw = dict(max_batch=B, max_len=MAX_LEN + cfg_t.n_patches, wire=wire)
    return (JServeSession(JServePlan(arch=cfg_j, **kw), pj),
            ServeSession(ServePlan(arch=cfg_t, **kw), pt, device="cpu"))


def _records(cost):
    return [(w.name, tuple(w.shape), str(w.dtype).replace("torch.", ""),
             w.direction, w.bytes, w.physical) for w in cost.wires]


def _jrecords(cost):
    return [(w.name, tuple(w.shape), jnp.dtype(w.dtype).name, w.direction,
             w.bytes, w.physical) for w in cost.wires]


@pytest.fixture(scope="module")
def served(setup):
    """wire -> (port tokens, reference tokens, port session, ref session)"""
    _, _, _, _, _, _, prompt, patches = setup
    out = {}
    for name, wire in WIRES.items():
        js, ts = _sessions(setup, wire)
        out[name] = (ts.generate(torch.from_numpy(prompt), GEN,
                                 extra={"patch_embeds":
                                        torch.from_numpy(patches)}).numpy(),
                     np.asarray(js.generate(
                         jnp.asarray(prompt), GEN,
                         extra={"patch_embeds": jnp.asarray(patches)})),
                     ts, js)
    return out


@pytest.mark.parametrize("wire", list(WIRES))
def test_split_serving_with_patches_matches_reference(setup, served, wire):
    """Tokens and every decode and prefill record equal the reference's;
    the prefill's cut activation carries the patches' rows."""
    cfg_t, prompt, patches = setup[3], setup[6], setup[7]
    toks_t, toks_j, ts, js = served[wire]
    np.testing.assert_array_equal(toks_t, toks_j)
    assert _records(ts.decode_cost(1)) == _jrecords(js.decode_cost(1))
    extra_t = {"patch_embeds": torch.from_numpy(patches)}
    extra_j = {"patch_embeds": jnp.asarray(patches)}
    pc_t, pc_j = ts.prefill_cost(B, S, extra_t), js.prefill_cost(B, S,
                                                                 extra_j)
    assert _records(pc_t) == _jrecords(pc_j)
    up = pc_t.wires[0]
    assert up.name == "prefill_act" and tuple(up.shape) == \
        (B, cfg_t.n_patches + S, cfg_t.d_model)
    row = cfg_t.d_model + 4 if wire != "dense" else 4 * cfg_t.d_model
    assert up.bytes == B * (cfg_t.n_patches + S) * row
    assert ts.bytes_per_token() == js.bytes_per_token()


def test_physical_equals_fake_and_split_equals_monolithic(setup, served):
    cfg_t, mt, pt, prompt, patches = setup[3:8]
    np.testing.assert_array_equal(served["physical_q8"][0],
                                  served["fake_q8"][0])
    _, mono = _mono_t(mt, pt, cfg_t, prompt, patches)
    np.testing.assert_array_equal(served["dense"][0], mono)


def test_batcher_join_with_patches_matches_reference(setup):
    """Tenant 0 seated, 2 steps, tenant 1 joins: both streams, the bytes
    and the tokens counted equal the reference's `Batcher`, and each
    stream its solo session's."""
    cfg_j, _, pj, cfg_t, _, pt, prompt, patches = setup
    kw = dict(max_batch=3, max_len=MAX_LEN + cfg_t.n_patches,
              wire="quantize_int8:physical")
    jb = JBatcher(JServeSession(JServePlan(arch=cfg_j, **kw), pj))
    tb = Batcher(ServeSession(ServePlan(arch=cfg_t, **kw), pt, device="cpu"))
    prompts = [prompt[0], prompt[1, :5]]
    for b, conv in ((jb, jnp.asarray), (tb, torch.from_numpy)):
        assert b.join(conv(prompts[0]), GEN,
                      extra={"patch_embeds": conv(patches[:1])}) == 0
        for _ in range(2):
            b.step()
        assert b.join(conv(prompts[1]), GEN,
                      extra={"patch_embeds": conv(patches[1:])}) == 1
    done_j, done_t = jb.run(), tb.run()
    streams_t = {t.slot: t.tokens for t in done_t}
    assert streams_t == {t.slot: t.tokens for t in done_j}
    assert (tb.bytes_up, tb.bytes_down, tb.tokens_generated) == \
        (jb.bytes_up, jb.bytes_down, jb.tokens_generated)
    d = cfg_t.d_model + 4
    v = cfg_t.vocab + 4
    assert tb.bytes_up + tb.bytes_down == sum(
        (cfg_t.n_patches + len(p)) * d + v + (GEN - 1) * (d + v)
        for p in prompts)
    sess = ServeSession(ServePlan(arch=cfg_t, **{**kw, "max_batch": 1}), pt,
                        device="cpu")
    for slot, p in enumerate(prompts):
        solo = sess.generate(torch.from_numpy(p)[None], GEN, extra={
            "patch_embeds": torch.from_numpy(patches[slot:slot + 1])})
        assert solo[0].tolist() == streams_t[slot]


def test_input_specs_match_reference():
    cfg_j, cfg_t = jget_config(ARCH), get_config(ARCH)
    for name, shape in INPUT_SHAPES.items():
        want = jinput_specs(cfg_j, JINPUT_SHAPES[name])
        got = input_specs(cfg_t, shape)
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape, (name, k)
    assert tuple(input_specs(cfg_t, INPUT_SHAPES["prefill_32k"])[
        "patch_embeds"].shape) == (32, 256, 1024)


def test_serve_cli_refuses_a_vlm():
    for split in ([], ["--split"]):
        with pytest.raises(SystemExit, match="extra="):
            tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu"]
                        + split)


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["monolithic", "fedavg"])
def test_train_cli_matches_reference_keys(mode, monkeypatch, capsys):
    argv = ["--arch", ARCH, "--reduced", "--steps", "2", "--mode", mode,
            "--n-clients", "2", "--batch", "2", "--seq", "8",
            "--log-every", "0"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jtrain.main()
    sj = _last_json(capsys.readouterr().out)
    run = ttrain.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-2].startswith("eval acc/client: [")
    st = _last_json(out)
    assert list(st) == list(sj)
    assert (st["arch"], st["mode"], st["steps"]) == \
        (sj["arch"], sj["mode"], sj["steps"])
    assert all(np.isfinite(run.losses)) and len(run.losses) == 2
    batch = run.round_batches(0)[0]
    assert tuple(batch["patch_embeds"].shape) == (2, 8, 64)
    assert tuple(batch["tokens"].shape) == (2, 8)


def test_train_cli_refuses_split():
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        ttrain.main(["--arch", ARCH, "--reduced", "--steps", "1", "--mode",
                     "split", "--device", "cpu"])
