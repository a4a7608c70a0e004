"""The port's monolithic serving against the JAX reference.

Reduced models (fp32, vocab 97, the reference's parameters from
PRNGKey(0) bridged over, prompts (2, 7) from PRNGKey(1)), on the CPU:

* `LM.init_cache` + `LM.prefill`: the logits at 1e-5 and every cache
  (rings, `pos`, conv windows, states) against the reference's
  `model.prefill`, and `greedy_decode_scan`'s tokens equal to the
  reference's, for phi4-mini, Mamba2, RecurrentGemma (6 layers, its
  8-row window wrapping), Qwen3-MoE and DeepSeek-V2;
* the monolithic tokens equal to the split `ServeSession`'s over the
  dense wire (the cut is invisible when nothing quantizes);
* `python -m repro_torch.launch.serve` without `--split` on the CPU:
  the reference's JSON keys (plus `device`), `--loop` accepted as a
  mode name, no fallback to the CPU without `--device cpu`;
* ChatGLM3-6B, Qwen1.5-32B and Mistral-Large-123B: the configs' fields
  equal the reference's, their full-width models on meta tensors have
  the reference's parameter count, and their reduced models (the QKV
  biases carried over by `bridge`) serve monolithic and split (dense and
  physical int8 wire) token for token as the reference's do; reduced
  ChatGLM3's `LM.loss` and its gradient over the whole tree, biases
  included, match the reference's (the training CLI takes these archs).
"""
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serve import ServePlan as JServePlan
from repro.serve import ServeSession as JServeSession
from repro.serve import greedy_decode_scan as jgreedy_decode_scan
from repro_torch import bridge
from repro_torch.configs import PORTED_ARCH_IDS, get_config
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build_model
from repro_torch.nn.module import param_count, tree_map
from repro_torch.serve import ServePlan, ServeSession, greedy_decode_scan

B, S, GEN = 2, 7, 6
MAX_LEN = S + GEN + 2
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5   # tests/test_torch_lm_train.py's
ARCHS = {"phi4_mini_3_8b": {}, "mamba2_130m": {},
         "recurrentgemma_2b": dict(n_layers=6, window=8),
         "qwen3_moe_30b_a3b": {}, "deepseek_v2_236b": {}}
NEW = ("chatglm3_6b", "qwen1_5_32b", "mistral_large_123b")


def _setup(arch, red):
    cfg_j = jget_config(arch).reduced(vocab=97, **red)
    model_j = jbuild_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    cfg_t = get_config(arch).reduced(vocab=97, **red)
    params_t = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t)
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                         97))
    return model_j, params_j, build_model(cfg_t), params_t, prompt


def _jmono(model_j, params_j, prompt):
    cache = model_j.init_cache(B, MAX_LEN)
    logits, cache = model_j.prefill(params_j, {"tokens": jnp.asarray(prompt)},
                                    cache)
    tok0 = jnp.argmax(logits[:, -1], -1)[:, None]
    rest, _ = jgreedy_decode_scan(model_j, params_j, cache, tok0, GEN - 1)
    return logits, cache, np.asarray(jnp.concatenate([tok0, rest], 1))


def _mono(model_t, params_t, prompt):
    cache = model_t.init_cache(B, MAX_LEN, "cpu")
    with torch.no_grad():
        logits, cache = model_t.prefill(
            params_t, {"tokens": torch.from_numpy(prompt).long()}, cache)
    tok0 = torch.argmax(logits[:, -1], -1)[:, None]
    rest, _ = greedy_decode_scan(model_t, params_t, cache, tok0, GEN - 1)
    return logits, cache, torch.cat([tok0, rest], 1)


def _check_caches(c_t, c_j):
    got = bridge.caches_to_numpy(c_t)
    want = jax.tree_util.tree_map(np.asarray, c_j)
    for g_t, g_j in zip(got, want, strict=True):
        assert g_t.keys() == g_j.keys()
        for i in g_t:
            assert g_t[i].keys() == g_j[i].keys()
            for k in g_t[i]:
                assert np.shape(g_t[i][k]) == np.shape(g_j[i][k])
                if k == "pos":
                    np.testing.assert_array_equal(g_t[i][k], g_j[i][k])
                else:
                    np.testing.assert_allclose(g_t[i][k], g_j[i][k], **TOL)


def test_prefill_and_scan_match_reference():
    """Per family: prefill logits and caches, then the greedy tokens."""
    for arch, red in ARCHS.items():
        model_j, params_j, model_t, params_t, prompt = _setup(arch, red)
        logits_j, cache_j, want = _jmono(model_j, params_j, prompt)
        logits_t, _, got = _mono(model_t, params_t, prompt)
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                   **TOL, err_msg=arch)
        cache_t = model_t.init_cache(B, MAX_LEN, "cpu")
        with torch.no_grad():
            model_t.prefill(params_t,
                            {"tokens": torch.from_numpy(prompt).long()},
                            cache_t)
        _check_caches(cache_t, cache_j)
        assert got.tolist() == want.tolist(), arch


def test_monolithic_equals_split_over_the_dense_wire():
    """Nothing quantizes on the dense wire, so the cut is invisible: the
    split session's tokens are the monolithic ones, at the default cut
    and at cut 1."""
    for arch, red in ARCHS.items():
        _, _, model_t, params_t, prompt = _setup(arch, red)
        mono = _mono(model_t, params_t, prompt)[2]
        cuts = (None, 1) if arch != "recurrentgemma_2b" else (None,)
        for cut in cuts:
            sess = ServeSession(ServePlan(arch=model_t.cfg, cut=cut,
                                          max_batch=B, max_len=MAX_LEN),
                                params_t, device="cpu")
            split = sess.generate(torch.from_numpy(prompt), GEN)
            assert split.tolist() == mono.tolist(), (arch, cut)


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = tlaunch.main(argv)
    return run, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_serves_monolithically_on_cpu():
    """No `--split`: the monolithic mode, the reference's keys plus
    `device`; `--loop` names its mode and decodes the same tokens (the
    port has one decode, see `launch/serve.py`); the returned tokens are
    a ServeSession's over the dense wire from the same seed; without a
    GPU and without `--device cpu` it raises."""
    argv = ["--arch", "chatglm3_6b", "--reduced", "--batch", "2",
            "--prompt-len", "9", "--gen", "5", "--device", "cpu"]
    run, out = _cli(argv)
    assert set(out) == {"arch", "batch", "prompt_len", "generated", "device",
                        "mode", "prefill_s", "decode_s", "decode_tok_per_s",
                        "sample_tokens"}
    assert out["mode"] == "monolithic" and out["device"] == "cpu"
    assert out["arch"] == "chatglm3-6b" and len(out["sample_tokens"]) == 5
    assert tuple(run.tokens.shape) == (2, 5)
    loop, out_loop = _cli(argv + ["--loop"])
    assert out_loop["mode"] == "monolithic_loop"
    assert torch.equal(loop.tokens, run.tokens)
    split, out_split = _cli(argv + ["--split"])
    assert out_split["mode"] == "split" and out_split["wire"] == "dense"
    assert torch.equal(split.tokens, run.tokens)
    assert tuple(run.step(run.tokens[:, -1:]).shape) == (2, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlaunch.main(["--arch", "chatglm3_6b", "--reduced"])


def _fields(cfg):
    return {f.name: (jnp.dtype(v).name if f.name == "dtype" and
                     not isinstance(v, torch.dtype) else
                     str(v).replace("torch.", "") if f.name == "dtype"
                     else v)
            for f in dataclasses.fields(cfg)
            for v in (getattr(cfg, f.name),)}


def test_new_configs_match_reference():
    """Every field equal to the reference's (dtype by name), registered
    in `PORTED_ARCH_IDS`; at full width on meta tensors the reference's
    parameter count (ChatGLM3 with its QKV biases, Qwen1.5-32B MHA 40/40,
    Mistral-Large at 88 layers and d 12,288)."""
    counts = {}
    for arch in NEW:
        assert arch in PORTED_ARCH_IDS
        cfg_t, cfg_j = get_config(arch), jget_config(arch)
        assert _fields(cfg_t) == _fields(cfg_j)
        params = build_model(cfg_t).init(torch.Generator(), "meta")
        shapes = jax.eval_shape(jbuild_model(cfg_j).init,
                                jax.random.PRNGKey(0))
        counts[arch] = param_count(params)
        assert counts[arch] == sum(int(np.prod(a.shape)) for a in
                                   jax.tree_util.tree_leaves(shapes))
        wq = params["groups"][0][0]["0"]["mixer"]["wq"]
        assert ("b" in wq) == cfg_t.qkv_bias
    assert round(counts["chatglm3_6b"] / 1e9, 2) == 6.24
    assert round(counts["qwen1_5_32b"] / 1e9, 1) == 35.2
    assert round(counts["mistral_large_123b"] / 1e9, 1) == 122.6


def _new_setup(arch):
    """A new config reduced (vocab 97): both models, the reference's
    params from PRNGKey(0) with the first layer's QKV biases moved off
    their zero init, and the port's bridged from them."""
    cfg_j = jget_config(arch).reduced(vocab=97)
    model_j = jbuild_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    if cfg_j.qkv_bias:
        rng = np.random.default_rng(3)
        mixer = params_j["groups"][0]["0"]["mixer"]
        for w in ("wq", "wk", "wv"):
            mixer[w]["b"] = jnp.asarray(0.1 * rng.standard_normal(
                mixer[w]["b"].shape).astype(np.float32))
    cfg_t = get_config(arch).reduced(vocab=97)
    params_t = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t)
    assert ("b" in params_t["groups"][0][0]["0"]["mixer"]["wk"]) == \
        cfg_t.qkv_bias
    return cfg_j, model_j, params_j, cfg_t, params_t


def test_new_configs_serve_like_reference():
    """Reduced ChatGLM3 (rope on half the head, QKV bias), Qwen1.5 (QKV
    bias) and Mistral-Large (rope theta 1e6): monolithic tokens equal to
    the reference's greedy decode, split tokens over the dense and the
    physical int8 wire equal to the reference's `ServeSession`; the
    biases (moved off their zero init) reach the port through `bridge`."""
    for arch in NEW:
        cfg_j, model_j, params_j, cfg_t, params_t = _new_setup(arch)
        prompt = np.array(jax.random.randint(jax.random.PRNGKey(1), (B, S),
                                             0, 97))
        want = _jmono(model_j, params_j, prompt)[2]
        got = _mono(build_model(cfg_t), params_t, prompt)[2]
        assert got.tolist() == want.tolist(), arch
        for wire in ("", "quantize_int8:physical"):
            kw = dict(max_batch=B, max_len=MAX_LEN, wire=wire)
            js = JServeSession(JServePlan(arch=cfg_j, **kw), params_j)
            ts = ServeSession(ServePlan(arch=cfg_t, **kw), params_t,
                              device="cpu")
            assert ts.generate(torch.from_numpy(prompt), GEN).tolist() == \
                np.asarray(js.generate(jnp.asarray(prompt), GEN)).tolist(), \
                (arch, wire)


def test_new_configs_train_like_reference():
    """Reduced ChatGLM3, which carries the layer options the three new
    configs bring to training (rope on half the head, QKV bias; Qwen1.5
    and Mistral-Large differ from it in widths, head counts and rope
    theta only): the masked `LM.loss` at 1e-5 and its gradient over the
    whole tree (QKV biases, embedding and head included) leafwise within
    1e-4 relative plus 1e-5 of the leaf's largest gradient, against the
    reference's `model.loss` under `jax.grad` (compiled: eager JAX takes
    three times longer here)."""
    _, model_j, params_j, cfg_t, params_t = _new_setup("chatglm3_6b")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 97, (B, S + 1))
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    loss_j, grads_j = jax.jit(jax.value_and_grad(model_j.loss))(params_j, {
        "tokens": jnp.asarray(toks[:, :-1], jnp.int32),
        "labels": jnp.asarray(toks[:, 1:], jnp.int32),
        "loss_mask": jnp.asarray(mask)})
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(),
                      params_t)
    loss_t = build_model(cfg_t).loss(leaves, {
        "tokens": torch.from_numpy(toks[:, :-1]),
        "labels": torch.from_numpy(toks[:, 1:]),
        "loss_mask": torch.from_numpy(mask)})
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), **TOL)
    got = jax.tree_util.tree_leaves(bridge.params_to_numpy(tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad,
        leaves)))
    want = jax.tree_util.tree_leaves(grads_j)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(
            g, w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(float(np.abs(w).max()), 1e-30))
