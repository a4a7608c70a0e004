"""The long-context variant and remat against the JAX reference, on the
CPU (fp32, TF32 off; the reference's parameters from PRNGKey(0) bridged
over, tokens drawn with numpy from a seed).

* Long-context serving: reduced phi4-mini (dense GQA), Qwen3-MoE (the
  MoE path) and DeepSeek-V2 (MLA), each with `long_window=16` and built
  with `long_context=True` in both packages (every attention block
  within 16 rows, a 16-row ring): a 40-token prompt, then 24 greedy
  decode steps, so the ring wraps at prefill and again while decoding.
  Prefill logits within rtol = atol = 1e-5, every greedy token equal.
* One decode at cursor 524,280 (`long_500k`'s last rows) of the
  long-context phi4-mini over the same seeded ring contents bridged into
  both packages: logits and the ring after it within 1e-5.  Rope at
  that position takes fp32 angles of 5.2e5 radians, so the frequencies
  must be the reference's bit for bit (`nn.attention.rope_freqs`).
* Remat: `LM.loss(remat=True)` and its gradient BITWISE the
  `remat=False` ones in the port (the checkpointed repeats recompute the
  same arithmetic), and within the reference's `jax.grad` of
  `loss(..., remat=True)` at the LM training tests' tolerance (rtol
  1e-4, atol 1e-5 x the leaf's largest gradient: a backward sums over
  batch and sequence in another order), the loss at 1e-5, for reduced
  phi4-mini (one layer a checkpoint) and RecurrentGemma (two (rglru,
  rglru, attn) super-blocks and a remainder layer, one super-block a
  checkpoint).  An encoder-decoder model accepts `remat` and ignores
  it, as the reference's does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serve import greedy_decode_scan as jgreedy_decode_scan
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.nn.module import tree_leaves, tree_map
from repro_torch.serve import greedy_decode_scan
from _torch_threads import one_torch_thread

one_torch_thread()

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5   # tests/test_torch_lm_train.py's
VOCAB, B, PROMPT, GEN, WINDOW = 97, 2, 40, 24, 16
LONG_ARCHS = ("phi4_mini_3_8b", "qwen3_moe_30b_a3b", "deepseek_v2_236b")
CURSOR, LONG_LEN = 524_280, 524_288


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _models(arch, long_context=True, **red):
    red = dict(vocab=VOCAB, long_window=WINDOW, **red)
    cfg_j = jget_config(arch).reduced(**red)
    model_j = jbuild_model(cfg_j, long_context=long_context)
    params_j = model_j.init(jax.random.PRNGKey(0))
    cfg_t = get_config(arch).reduced(**red)
    params_t = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t)
    return model_j, params_j, build_model(cfg_t, long_context=long_context), \
        params_t


@pytest.mark.parametrize("arch", LONG_ARCHS)
def test_long_context_serving_across_the_wrap(arch):
    model_j, params_j, model_t, params_t = _models(arch)
    attn = [s.attn for g in model_t.groups for s in g.specs]
    assert all(a.window == WINDOW for a in attn)
    prompt = np.random.default_rng(3).integers(0, VOCAB, (B, PROMPT))
    max_len = PROMPT + GEN + 1

    cache_j = model_j.init_cache(B, max_len)
    logits_j, cache_j = model_j.prefill(
        params_j, {"tokens": jnp.asarray(prompt)}, cache_j)
    tok0_j = jnp.argmax(logits_j[:, -1], -1)[:, None]
    rest_j, _ = jgreedy_decode_scan(model_j, params_j, cache_j, tok0_j,
                                    GEN - 1)
    want = np.asarray(jnp.concatenate([tok0_j, rest_j], 1))

    cache_t = model_t.init_cache(B, max_len, "cpu")
    ring = tree_leaves(cache_t)[0]
    assert ring.shape[1] == WINDOW          # the ring holds the window
    with torch.no_grad():
        logits_t, cache_t = model_t.prefill(
            params_t, {"tokens": torch.from_numpy(prompt).long()}, cache_t)
        tok0 = torch.argmax(logits_t[:, -1], -1)[:, None]
        rest, _ = greedy_decode_scan(model_t, params_t, cache_t, tok0,
                                     GEN - 1)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               **TOL)
    assert torch.cat([tok0, rest], 1).tolist() == want.tolist()


def test_decode_at_cursor_524280():
    arch = "phi4_mini_3_8b"
    model_j, params_j, model_t, params_t = _models(arch)
    cache_j = jax.eval_shape(lambda: model_j.init_cache(B, LONG_LEN))
    rng = np.random.default_rng(4)

    def fill(leaf):
        if leaf.dtype == jnp.int32:                  # the cursors
            return np.full(leaf.shape, CURSOR, np.int32)
        return rng.standard_normal(leaf.shape).astype(np.float32)
    ring_np = jax.tree_util.tree_map(fill, cache_j)
    assert ring_np[0]["0"]["k"].shape[2] == WINDOW
    tok = rng.integers(0, VOCAB, (B, 1))

    logits_j, new_j = model_j.decode_step(
        params_j, jnp.asarray(tok), jax.tree_util.tree_map(jnp.asarray,
                                                           ring_np))
    cache_t = bridge.caches_from_jax(ring_np)
    assert cache_t[0][0]["0"]["pos"] == CURSOR
    with torch.no_grad():
        logits_t, cache_t = model_t.decode_step(
            params_t, torch.from_numpy(tok).long(), cache_t)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               **TOL)
    got = bridge.caches_to_numpy(cache_t)
    want = jax.tree_util.tree_map(np.asarray, new_j)
    for k in ("k", "v"):
        np.testing.assert_allclose(got[0]["0"][k], want[0]["0"][k], **TOL)
    np.testing.assert_array_equal(got[0]["0"]["pos"], want[0]["0"]["pos"])


REMAT = {"phi4_mini_3_8b": {},
         "recurrentgemma_2b": dict(n_layers=7, window=8)}


def _close_grads(t_leaves, j_leaves):
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale)


@pytest.mark.parametrize("arch", list(REMAT))
def test_remat_loss_and_grads(arch):
    model_j, params_j, model_t, params_t = _models(arch, long_context=False,
                                                   **REMAT[arch])
    if arch == "recurrentgemma_2b":      # super-blocks and a remainder
        assert [g.n_repeat for g in model_t.groups] == [2, 1]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, VOCAB, (B, 20))
    batch_np = {"tokens": toks, "labels": np.roll(toks, -1, 1)}

    def port(remat):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(),
                     params_t)
        batch = {k: torch.from_numpy(v).long() for k, v in batch_np.items()}
        loss = model_t.loss(p, batch, remat=remat)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        return loss.detach(), grads, p

    loss_r, grads_r, p_r = port(True)
    loss_n, grads_n, _ = port(False)
    assert torch.equal(loss_r, loss_n)
    for a, b in zip(grads_r, grads_n, strict=True):
        assert torch.equal(a, b)

    batch_j = {k: jnp.asarray(v, jnp.int32) for k, v in batch_np.items()}
    loss_j, grads_j = jax.value_and_grad(
        lambda p: model_j.loss(p, batch_j, remat=True))(params_j)
    np.testing.assert_allclose(float(loss_r), float(loss_j), **TOL)
    # the port's gradient tree restacked into the reference's layout
    it = iter(grads_r)
    stacked = bridge.lm_tree_to_ref(tree_map(lambda _: next(it), p_r))
    _close_grads(jax.tree_util.tree_leaves(bridge.tree_to_numpy(stacked)),
                 [np.asarray(b) for b in jax.tree_util.tree_leaves(grads_j)])


def test_encdec_accepts_remat():
    cfg = get_config("whisper_base").reduced(vocab=VOCAB)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, VOCAB, (B, 6))).long()
    batch = {"tokens": toks, "labels": toks,
             "audio_feats": torch.from_numpy(rng.standard_normal(
                 (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))}
    with torch.no_grad():
        assert torch.equal(model.loss(params, batch, remat=True),
                           model.loss(params, batch))
