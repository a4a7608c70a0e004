"""The port's `Batcher` over the SSM, hybrid and MoE families, against
the JAX reference's `Batcher`.

Each reduced model (fp32, vocab 97, the reference's parameters from
PRNGKey(0) bridged over) is served over the physical int8 wire with 3
slots: tenant 0 (a 7-token prompt) seated, 3 steps, then tenant 1 (11
tokens) joining mid-flight, 6 tokens each.  The streams, `bytes_up`,
`bytes_down`, `tokens_generated` and the stacked server cache (`pos`
exactly, the rest at 1e-5; Qwen3-MoE its `pos` only) equal the
reference's:

* Mamba2 (conv window and SSD state per row, no cursor) and
  RecurrentGemma (6 layers, an 8-row attention window, so each row's
  ring wraps on its own), whose streams also equal each tenant's solo
  B=1 `ServeSession` stream;
* DeepSeek-V2 (MLA's compressed ring per row, MoE with a shared
  expert) and Qwen3-MoE through the fused q8 entry, held to the
  reference's `Batcher` only: at the capacity dispatch the pad rows
  compete for expert capacity, so a MoE server step need not be
  row-independent.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serve import Batcher as JBatcher
from repro.serve import ServePlan as JServePlan
from repro.serve import ServeSession as JServeSession
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.serve import Batcher, ServePlan, ServeSession

GEN, SLOTS, MAX_LEN = 6, 3, 20
PROMPTS = (7, 11)
WIRE = "quantize_int8:physical"
TOL = dict(rtol=1e-5, atol=1e-5)


def _serve(arch, red, solo: bool, fused: bool = False, rings=True):
    cfg_j = jget_config(arch).reduced(vocab=97, **red)
    params_j = jbuild_model(cfg_j).init(jax.random.PRNGKey(0))
    cfg_t = get_config(arch).reduced(vocab=97, **red)
    params_t = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t)
    keys = jax.random.split(jax.random.PRNGKey(1), len(PROMPTS))
    prompts = [np.array(jax.random.randint(k, (s,), 0, 97))
               for k, s in zip(keys, PROMPTS)]
    kw = dict(max_batch=SLOTS, max_len=MAX_LEN, wire=WIRE, fused_entry=fused)
    jb = JBatcher(JServeSession(JServePlan(arch=cfg_j, **kw), params_j))
    tb = Batcher(ServeSession(ServePlan(arch=cfg_t, **kw), params_t,
                              device="cpu"))
    for b in (jb, tb):
        b.join(prompts[0], GEN)
        for _ in range(3):
            b.step()
        b.join(prompts[1], GEN)
    got = {t.slot: t.tokens for t in tb.run()}
    assert got == {t.slot: t.tokens for t in jb.run()}
    assert (tb.bytes_up, tb.bytes_down, tb.tokens_generated) == \
        (jb.bytes_up, jb.bytes_down, jb.tokens_generated)
    assert tb.tokens_generated == 2 * GEN
    got_c = bridge.caches_to_numpy(tb._sc)
    want_c = jax.tree_util.tree_map(np.asarray, jb._sc)
    for g_t, g_j in zip(got_c, want_c, strict=True):
        for i in g_t:
            assert g_t[i].keys() == g_j[i].keys()
            for k in g_t[i]:
                if k == "pos":
                    np.testing.assert_array_equal(g_t[i][k], g_j[i][k])
                elif rings:
                    np.testing.assert_allclose(g_t[i][k], g_j[i][k], **TOL)
    if solo:
        plan = ServePlan(arch=cfg_t, max_batch=1, max_len=MAX_LEN, wire=WIRE)
        for slot, prompt in enumerate(prompts):
            sess = ServeSession(plan, params_t, device="cpu")
            want = sess.generate(torch.from_numpy(prompt)[None], GEN)
            assert got[slot] == want[0].tolist()
    return tb


def test_mamba2_batcher():
    tb = _serve("mamba2_130m", {}, solo=True)
    assert "pos" not in tb._sc[0][0]["0"]


def test_recurrentgemma_batcher_ring_wraps_per_row():
    tb = _serve("recurrentgemma_2b", dict(n_layers=6, window=8), solo=True)
    ring = tb._sc[0][0]["2"]
    assert ring["k"].shape[1] == 8
    # 8 steps: slot 0 (7 + 8) and slot 1 (11 + 5) past the 8-row window,
    # the pad slot 2 at its edge
    assert ring["pos"].tolist() == [15, 16, 8]


def test_deepseek_v2_batcher_against_the_reference():
    tb = _serve("deepseek_v2_236b", {}, solo=False)
    assert set(tb._sc[0][0]["0"]) == {"c_kv", "k_pe", "pos"}


def test_qwen3_moe_batcher_fused_entry_against_the_reference():
    """Streams, bytes and cursors only: one row of tenant 1's packed
    prefill activation lies on an int8 rounding boundary between the
    frameworks' fp32 results, so its server K/V row moves by a level (as
    in `test_torch_moe_serve.py`, which holds the server caches over the
    dense wire only)."""
    tb = _serve("qwen3_moe_30b_a3b", {}, solo=False, fused=True, rings=False)
    assert tb.session._fused["spec"].mlp == "moe"
