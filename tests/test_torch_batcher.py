"""The port's continuous-batching `Batcher` and per-row cache cursors,
against the JAX reference.

Reduced phi4-mini (2 layers, d_model 128, vocab 97, fp32), the
reference's parameters from PRNGKey(0) bridged over, two prompts of 7
and 11 tokens from PRNGKey(1); everything on the CPU:

* `Batcher` over the physical int8 wire, plain and through the fused q8
  entry, 3 slots, tenant 0 seated, 3 steps, then tenant 1 joining
  mid-flight: every stream equal token for token to the reference's
  `Batcher` and to the tenant's solo B=1 `ServeSession` stream,
  `bytes_up`, `bytes_down` and `tokens_generated` equal to the
  reference's, and the stacked server cache (per-row `pos` included)
  allclose to the reference's at 1e-5;
* `gqa_decode` (plain and within a sliding window whose ring wraps) and
  `mla_decode` with a per-row (B,) cursor, rows at different positions,
  against the reference's per-row case at 1e-5; with every row at one
  position the per-row path is bitwise the scalar path;
* EOS two ways: with the reference test's own `eos_id` (the solo
  stream's second token, which on this tree equals its first, so both
  packages retire the tenant after one token), and with a token that
  first appears at position k >= 1, so the tenant ends with k + 1
  tokens and `free_slots()` gives its slot back at once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.nn import attention as JA
from repro.serve import Batcher as JBatcher
from repro.serve import ServePlan as JServePlan
from repro.serve import ServeSession as JServeSession
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models.lm import per_slot_pos
from repro_torch.nn import attention as TA
from repro_torch.serve import Batcher, ServePlan, ServeSession
from _torch_threads import one_torch_thread

one_torch_thread()

ARCH = "phi4_mini_3_8b"
GEN, SLOTS, MAX_LEN = 6, 3, 20
PROMPTS = (7, 11)
WIRE = "quantize_int8:physical"
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.fixture(scope="module")
def setup():
    cfg_j = jget_config(ARCH).reduced(vocab=97)
    params_j = jbuild_model(cfg_j).init(jax.random.PRNGKey(0))
    cfg_t = get_config(ARCH).reduced(vocab=97)
    params_t = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t)
    keys = jax.random.split(jax.random.PRNGKey(1), len(PROMPTS))
    prompts = [np.array(jax.random.randint(k, (s,), 0, 97))
               for k, s in zip(keys, PROMPTS)]
    return cfg_j, params_j, cfg_t, params_t, prompts


def _batchers(setup, fused=False, eos_id=None, slots=SLOTS):
    cfg_j, params_j, cfg_t, params_t, _ = setup
    kw = dict(max_batch=slots, max_len=MAX_LEN, wire=WIRE,
              fused_entry=fused)
    return (JBatcher(JServeSession(JServePlan(arch=cfg_j, **kw), params_j),
                     eos_id=eos_id),
            Batcher(ServeSession(ServePlan(arch=cfg_t, **kw), params_t,
                                 device="cpu"), eos_id=eos_id))


def _solo(setup, prompt, fused=False):
    cfg_t, params_t = setup[2], setup[3]
    sess = ServeSession(ServePlan(arch=cfg_t, max_batch=1, max_len=MAX_LEN,
                                  wire=WIRE, fused_entry=fused), params_t,
                        device="cpu")
    return sess.generate(torch.from_numpy(prompt)[None], GEN)[0].tolist()


def _check_stacked(c_t, c_j):
    got = bridge.caches_to_numpy(c_t)
    want = jax.tree_util.tree_map(np.asarray, c_j)
    for g_t, g_j in zip(got, want, strict=True):
        for i in g_t:
            assert g_t[i].keys() == g_j[i].keys()
            for k in g_t[i]:
                assert np.shape(g_t[i][k]) == np.shape(g_j[i][k])
                if k == "pos":
                    np.testing.assert_array_equal(g_t[i][k], g_j[i][k])
                else:
                    _close(g_t[i][k], g_j[i][k])


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_batcher_matches_reference_and_solo(setup, fused):
    """Tenant 1 joins after 3 steps of tenant 0; both streams equal the
    reference's `Batcher` and their solo streams; bytes, tokens and the
    stacked server cache equal the reference's."""
    prompts = setup[4]
    jb, tb = _batchers(setup, fused)
    for b in (jb, tb):
        assert b.join(prompts[0], GEN) == 0
        for _ in range(3):
            b.step()
        assert b.join(prompts[1], GEN) == 1
    assert tb._sc[0][0]["0"]["pos"].tolist() == \
        np.asarray(jb._sc[0]["0"]["pos"])[0].tolist()
    got = {t.slot: t.tokens for t in tb.run()}
    want = {t.slot: t.tokens for t in jb.run()}
    assert got == want
    for slot, prompt in enumerate(prompts):
        assert got[slot] == _solo(setup, prompt, fused)
    assert (tb.bytes_up, tb.bytes_down, tb.tokens_generated) == \
        (jb.bytes_up, jb.bytes_down, jb.tokens_generated)
    d, v = setup[2].d_model, setup[2].vocab
    assert tb.bytes_up == sum(s * (d + 4) for s in PROMPTS) + \
        2 * (GEN - 1) * (d + 4)
    assert tb.bytes_down == 2 * GEN * (v + 4)
    assert tb.tokens_generated == 2 * GEN and tb.free_slots() == [0, 1, 2]
    _check_stacked(tb._sc, jb._sc)


def _ring(seed, B, T, K, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, K, hd)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("window", [None, 8], ids=["plain", "window"])
def test_per_row_gqa_decode_matches_reference(window):
    """Rows at positions 3, 17 and 8 (past an 8-row window, the ring
    wraps per row): output and ring at 1e-5, `pos` advanced per row;
    every row at position 5: the per-row path bitwise the scalar path."""
    B, T = 3, (8 if window else 24)
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              window=window, qkv_bias=True, rope_fraction=0.5)
    jcfg, tcfg = JA.AttnConfig(**kw), TA.AttnConfig(**kw)
    pj = JA.gqa_init(jax.random.PRNGKey(2), jcfg)
    pt = bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    k, v = _ring(3, B, T, 2, 16)
    x = np.random.default_rng(4).standard_normal((B, 1, 64)).astype(
        np.float32)
    pos = np.array([3, 17, 8], np.int32)
    y_j, c_j = JA.gqa_decode(pj, jcfg, jnp.asarray(x),
                             {"k": jnp.asarray(k), "v": jnp.asarray(v),
                              "pos": jnp.asarray(pos)})
    c_t = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
           "pos": torch.from_numpy(pos)}
    y_t, c_t = TA.gqa_decode(pt, tcfg, torch.from_numpy(x), c_t)
    _close(y_t, y_j)
    _close(c_t["k"], c_j["k"])
    _close(c_t["v"], c_j["v"])
    assert c_t["pos"].tolist() == np.asarray(c_j["pos"]).tolist() == \
        [4, 18, 9]
    def ring(pos):
        return {"k": torch.from_numpy(k.copy()),
                "v": torch.from_numpy(v.copy()), "pos": pos}
    scalar = ring(5)
    per_row = ring(torch.full((B,), 5, dtype=torch.int32))
    y_s, scalar = TA.gqa_decode(pt, tcfg, torch.from_numpy(x), scalar)
    y_r, per_row = TA.gqa_decode(pt, tcfg, torch.from_numpy(x), per_row)
    assert torch.equal(y_s, y_r) and scalar["pos"] == 6
    assert torch.equal(scalar["k"], per_row["k"])
    assert torch.equal(scalar["v"], per_row["v"])


def test_per_row_mla_decode_matches_reference():
    """MLA's compressed ring with rows at positions 2, 9 and 5: output,
    c_kv and k_pe at 1e-5; uniform rows bitwise the scalar path."""
    B, T = 3, 12
    kw = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=24, kind="mla",
              q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
              qk_rope_head_dim=8, v_head_dim=16)
    jcfg, tcfg = JA.AttnConfig(**kw), TA.AttnConfig(**kw)
    pj = JA.mla_init(jax.random.PRNGKey(5), jcfg)
    pt = bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    rng = np.random.default_rng(6)
    c_kv = rng.standard_normal((B, T, 16)).astype(np.float32)
    k_pe = rng.standard_normal((B, T, 8)).astype(np.float32)
    x = rng.standard_normal((B, 1, 64)).astype(np.float32)
    pos = np.array([2, 9, 5], np.int32)

    def cache(p):
        return {"c_kv": torch.from_numpy(c_kv.copy()),
                "k_pe": torch.from_numpy(k_pe.copy()), "pos": p}
    y_j, c_j = JA.mla_decode(pj, jcfg, jnp.asarray(x),
                             {"c_kv": jnp.asarray(c_kv),
                              "k_pe": jnp.asarray(k_pe),
                              "pos": jnp.asarray(pos)})
    y_t, c_t = TA.mla_decode(pt, tcfg, torch.from_numpy(x),
                             cache(torch.from_numpy(pos)))
    _close(y_t, y_j)
    _close(c_t["c_kv"], c_j["c_kv"])
    _close(c_t["k_pe"], c_j["k_pe"])
    assert c_t["pos"].tolist() == [3, 10, 6]
    y_s, c_s = TA.mla_decode(pt, tcfg, torch.from_numpy(x), cache(4))
    y_r, c_r = TA.mla_decode(pt, tcfg, torch.from_numpy(x),
                             cache(torch.full((B,), 4, dtype=torch.int32)))
    assert torch.equal(y_s, y_r)
    assert all(torch.equal(c_s[k], c_r[k]) for k in ("c_kv", "k_pe"))


def test_per_slot_pos_layout(setup):
    """Every ring's `pos` becomes a (B,) int32 on the ring's device; the
    layout bridges to the reference's `per_slot_pos` tree."""
    from repro.models.lm import per_slot_pos as jper_slot_pos
    cfg_j, _, cfg_t, _, _ = setup
    _, sc_j = jbuild_model(cfg_j).init_cache_split(SLOTS, MAX_LEN, 1)
    from repro_torch.models import build_model
    _, sc_t = build_model(cfg_t).init_cache_split(SLOTS, MAX_LEN, 1, "cpu")
    sc_t = per_slot_pos(sc_t, SLOTS)
    pos = sc_t[0][0]["0"]["pos"]
    assert pos.dtype == torch.int32 and pos.tolist() == [0] * SLOTS
    _check_stacked(sc_t, jper_slot_pos(sc_j, SLOTS))


def test_batcher_eos_as_the_reference_chooses_it(setup):
    """The reference test's EOS: the solo stream's second token.  On this
    tree the solo stream's first two tokens are equal, so the EOS is also
    the first token, and both packages retire the tenant after ONE token
    (the reference test's `len == 2` cannot hold); its slot is free at
    once and takes the next tenant.  The prompts are that test's own:
    randint(PRNGKey(1), (2, 7)), two rows."""
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 7), 0,
                                          97))
    solo = _solo(setup, prompts[0])
    eos = solo[1]
    assert solo[0] == eos
    jb, tb = _batchers(setup, eos_id=eos, slots=1)
    runs = []
    for b in (jb, tb):
        b.join(prompts[0], GEN)
        done = b.run()
        assert b.free_slots() == [0]
        b.join(prompts[1], 2)
        runs.append(([t.tokens for t in done], [t.tokens for t in b.run()]))
    assert runs[0] == runs[1]
    assert runs[1][0] == [[eos]]
    assert (tb.bytes_up, tb.bytes_down, tb.tokens_generated) == \
        (jb.bytes_up, jb.bytes_down, jb.tokens_generated)


def test_batcher_eos_at_a_later_position(setup):
    """An `eos_id` that first appears at position k >= 1 of the solo
    stream: the tenant ends with k + 1 tokens, the solo stream's prefix,
    and its slot is free right after the step that sampled it."""
    prompts = setup[4]
    solo = _solo(setup, prompts[1])
    k = next(i for i in range(1, GEN) if solo[i] not in solo[:i])
    _, tb = _batchers(setup, eos_id=solo[k])
    tb.join(prompts[0], GEN)
    slot = tb.join(prompts[1], GEN)
    for _ in range(k - 1):
        tb.step()
        assert slot not in tb.free_slots()
    out = tb.step()
    assert out[slot] == solo[k] and slot in tb.free_slots()
    ended = {t.slot: t.tokens for t in tb.finished}
    assert ended[slot] == solo[:k + 1]
