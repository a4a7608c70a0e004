"""The port's hybrid family (RecurrentGemma: RG-LRU blocks plus local
attention) split serving against the JAX reference.

Reduced RecurrentGemma-2B (6 layers as two (rglru, rglru, attn)
super-blocks, d_model 128, lru_width 128, 4 query heads and 1 KV head of
32, window 8, vocab 97, fp32), the reference's parameters from
PRNGKey(0) bridged over, inputs drawn with numpy from a seed:

* the tanh-gelu MLP, the RG-LRU gates, the log-depth scan, and the
  RG-LRU block's prefill (from a zero and from a carried cache) and
  decode: allclose at 1e-5 (the scan groups its sums differently from
  XLA's associative scan, and the matmuls sum in another order);
* `gqa_prefill` with a 16-row window at prompt 40 (the ring wraps):
  output, the whole ring and `pos`;
* the whole split `ServeSession` for the dense, fake-q8 and physical-q8
  wires at prompt 7 (inside the window) and 19 (past it, so the ring
  wraps at prefill and at every decode step): tokens equal to the JAX
  session's, `WireRecord`s equal record for record (and the packed cut
  payload bitwise), caches after prefill at 1e-5;
* one prefill equals the O(S) decode loop;
* the full-width configuration (26 layers, vocab 256,000, bf16) bills
  2,564 + 256,004 = 258,568 wire bytes per generated token per row,
  counted on meta tensors.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.nn import attention as JA
from repro.nn import layers as JL
from repro.nn import rglru as JR
from repro.serve import ServePlan as JServePlan
from repro.serve import ServeSession as JServeSession
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.wire_compress import pack_int8
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build_model
from repro_torch.nn import attention as TA
from repro_torch.nn import layers as L
from repro_torch.nn import rglru as R
from repro_torch.serve import ServePlan, ServeSession
from _torch_threads import one_torch_thread

one_torch_thread()

B, GEN = 2, 6
WINDOW = 8
PROMPTS = (7, 19)              # inside the window; past it (the ring wraps)
TOL = dict(rtol=1e-5, atol=1e-5)
WIRES = {"dense": "", "fake_q8": "quantize_int8",
         "physical_q8": "quantize_int8:physical"}
RED = dict(vocab=97, n_layers=6, window=WINDOW)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.fixture(scope="module")
def setup():
    cfg_j = jget_config("recurrentgemma_2b").reduced(**RED)
    params_j = jbuild_model(cfg_j).init(jax.random.PRNGKey(0))
    cfg_t = get_config("recurrentgemma_2b").reduced(**RED)
    params_t = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t)
    prompts = {s: np.array(jax.random.randint(jax.random.PRNGKey(1), (B, s),
                                              0, cfg_j.vocab))
               for s in PROMPTS}
    return cfg_j, params_j, cfg_t, params_t, prompts


@pytest.fixture(scope="module")
def block():
    """One RG-LRU mixer's params (reference init, bridged) and inputs."""
    kw = dict(d_model=64, lru_width=48)
    jcfg, tcfg = JR.RGLRUConfig(**kw), R.RGLRUConfig(**kw)
    pj = JR.rglru_init(jax.random.PRNGKey(3), jcfg)
    pt = bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    rng = np.random.default_rng(4)
    # the reference inits the gate biases to 0: move them off it
    for k in ("gate_a", "gate_x"):
        b = (0.5 * rng.standard_normal(48)).astype(np.float32)
        pj[k]["b"], pt[k]["b"] = jnp.asarray(b), torch.from_numpy(b)
    x = rng.standard_normal((B, 13, 64)).astype(np.float32)
    return jcfg, tcfg, pj, pt, x


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_gelu_mlp_matches_reference(bias):
    """The tanh gelu, as `jax.nn.gelu` defaults to; the erf gelu differs
    by more than the tolerance."""
    rng = np.random.default_rng(5)
    pj = JL.gelu_mlp_init(jax.random.PRNGKey(5), 32, 96, bias=bias)
    pt = bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    if bias:
        for k, n in (("fc1", 96), ("fc2", 32)):
            b = rng.standard_normal(n).astype(np.float32)
            pj[k]["b"], pt[k]["b"] = jnp.asarray(b), torch.from_numpy(b)
    assert set(pt["fc1"]) == ({"w", "b"} if bias else {"w"})
    x = (2 * rng.standard_normal((B, 5, 32))).astype(np.float32)
    want = JL.gelu_mlp_apply(pj, jnp.asarray(x))
    _close(L.gelu_mlp_apply(pt, torch.from_numpy(x)), want)
    erf = F.gelu(torch.from_numpy(x))
    assert not np.allclose(erf.numpy(), np.asarray(jax.nn.gelu(x)), **TOL)
    t = L.gelu_mlp_init(torch.Generator().manual_seed(0), 32, 96, bias=bias)
    assert tuple(t["fc1"]["w"].shape) == (32, 96) and \
        tuple(t["fc2"]["w"].shape) == (96, 32)


def test_rglru_gates_match_reference(block):
    _, _, pj, pt, _ = block
    x = np.random.default_rng(6).standard_normal((B, 5, 48)).astype(
        np.float32)
    a_j, u_j = JR._rglru_gates(pj, jnp.asarray(x))
    a_t, u_t = R._rglru_gates(pt, torch.from_numpy(x))
    assert a_t.dtype == u_t.dtype == torch.float32
    _close(a_t, a_j)
    _close(u_t, u_j)


@pytest.mark.parametrize("s", [1, 2, 13, 64, 300])
def test_rglru_scan_matches_reference(s):
    """The doubling scan against `jax.lax.associative_scan` and the
    sequential recurrence, at lengths that are and are not powers of 2."""
    rng = np.random.default_rng(7)
    a = rng.uniform(0.5, 1.0, (B, s, 16)).astype(np.float32)
    u = rng.standard_normal((B, s, 16)).astype(np.float32)
    got = R.rglru_scan(torch.from_numpy(a), torch.from_numpy(u))
    _close(got, JR.rglru_scan(jnp.asarray(a), jnp.asarray(u)))
    h, seq = np.zeros((B, 16), np.float64), []
    for t in range(s):
        h = a[:, t] * h + u[:, t]
        seq.append(h)
    _close(got, np.stack(seq, 1))


def test_rglru_init_matches_reference(block):
    jcfg, tcfg, pj, _, _ = block
    pt = R.rglru_init(torch.Generator().manual_seed(0), tcfg)
    assert pt["lam"].dtype == torch.float32
    _close(pt["lam"], pj["lam"], dict(rtol=1e-6, atol=1e-6))
    shapes = jax.tree_util.tree_map(np.shape, pj)
    assert bridge.tree_to_numpy(pt).keys() == shapes.keys()
    assert tuple(pt["conv"]["w"].shape) == (4, 48, 48) and "b" in pt["conv"]
    bf = R.rglru_init(torch.Generator().manual_seed(0),
                      R.RGLRUConfig(64, 48, dtype=torch.bfloat16))
    assert bf["lam"].dtype == torch.float32
    assert bf["in_x"]["w"].dtype == torch.bfloat16
    cache = R.rglru_init_cache(tcfg, B)
    want = JR.rglru_init_cache(jcfg, B)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in cache.items()} == \
        {k: (v.shape, jnp.dtype(v.dtype).name) for k, v in want.items()}


@pytest.mark.parametrize("step", ["prefill_zero", "prefill_carried",
                                  "decode"])
def test_rglru_block_matches_reference(block, step):
    jcfg, tcfg, pj, pt, x = block
    rng = np.random.default_rng(8)
    if step == "prefill_zero":
        cache = {k: np.asarray(v)
                 for k, v in JR.rglru_init_cache(jcfg, B).items()}
    else:
        cache = {"conv": rng.standard_normal((B, 3, 48)).astype(np.float32),
                 "h": rng.standard_normal((B, 48)).astype(np.float32)}
    fn_j = JR.rglru_block_decode if step == "decode" else JR.rglru_prefill
    fn_t = R.rglru_block_decode if step == "decode" else R.rglru_prefill
    xin = x[:, :1] if step == "decode" else x
    y_j, c_j = fn_j(pj, jcfg, jnp.asarray(xin),
                    jax.tree_util.tree_map(jnp.asarray, cache))
    y_t, c_t = fn_t(pt, tcfg, torch.from_numpy(xin),
                    bridge.tree_from_jax(cache))
    _close(y_t, y_j)
    for k in ("conv", "h"):
        assert tuple(c_t[k].shape) == tuple(np.shape(c_j[k]))
        _close(c_t[k], c_j[k])


def test_windowed_gqa_prefill_matches_reference():
    """A 16-row window at prompt 40: the output and the whole ring (the
    last 16 K/V rows at slots p % 16) and pos, against the reference."""
    kw = dict(d_model=64, n_heads=4, n_kv_heads=1, head_dim=32, window=16)
    jcfg, tcfg = JA.AttnConfig(**kw), TA.AttnConfig(**kw)
    pj = JA.gqa_init(jax.random.PRNGKey(9), jcfg)
    pt = bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    x = np.random.default_rng(9).standard_normal((B, 40, 64)).astype(
        np.float32)
    y_j, c_j = JA.gqa_prefill(pj, jcfg, jnp.asarray(x),
                              JA.gqa_init_cache(jcfg, B, 64))
    cache = TA.gqa_init_cache(tcfg, B, 64)
    assert tuple(cache["k"].shape) == (B, 16, 1, 32)
    y_t, c_t = TA.gqa_prefill(pt, tcfg, torch.from_numpy(x), cache)
    _close(y_t, y_j)
    for k in ("k", "v"):
        _close(c_t[k], c_j[k])
    assert c_t["pos"] == int(c_j["pos"]) == 40
    # decode one more token: it overwrites slot 40 % 16 and wraps
    x1 = x[:, :1]
    y_j, c_j = JA.gqa_decode(pj, jcfg, jnp.asarray(x1), c_j)
    y_t, c_t = TA.gqa_decode(pt, tcfg, torch.from_numpy(x1), c_t)
    _close(y_t, y_j)
    _close(c_t["k"], c_j["k"])


def test_hybrid_groups_follow_the_pattern():
    """26 layers: (rglru, rglru, attn) x 8 and a remainder (rglru, rglru);
    only the attention blocks carry the window; cuts fall on super-block
    boundaries."""
    model = build_model(get_config("recurrentgemma_2b"))
    (g0, g1) = model.groups
    assert [s.mixer for s in g0.specs] == ["rglru", "rglru", "attn"]
    assert (g0.n_repeat, [s.mixer for s in g1.specs], g1.n_repeat) == \
        (8, ["rglru", "rglru"], 1)
    assert model.flat_layers() == 26
    assert g0.specs[2].attn.window == 2048 and g0.specs[2].mlp == "gelu"
    assert all(s.mlp == "gelu" and not s.mlp_bias and s.d_ff == 7680
               for g in model.groups for s in g.specs)
    red = get_config("recurrentgemma_2b").reduced(**RED)
    params = build_model(red).init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="composite"):
        ServeSession(ServePlan(arch=red, cut=2), params, device="cpu")


# ---------------------------------------------------------------------------
# the split ServeSession
# ---------------------------------------------------------------------------

def _sessions(setup, wire, s):
    cfg_j, params_j, cfg_t, params_t, _ = setup
    js = JServeSession(JServePlan(arch=cfg_j, max_batch=B, max_len=s + GEN + 2,
                                  wire=wire), params_j)
    ts = ServeSession(ServePlan(arch=cfg_t, max_batch=B, max_len=s + GEN + 2,
                                wire=wire), params_t, device="cpu")
    return js, ts


def _records(cost):
    return [(w.name, tuple(w.shape), str(w.dtype).replace("torch.", ""),
             w.direction, w.bytes, w.physical) for w in cost.wires]


def _jrecords(cost):
    return [(w.name, tuple(w.shape), jnp.dtype(w.dtype).name, w.direction,
             w.bytes, w.physical) for w in cost.wires]


def _check_caches(c_t, c_j):
    got = bridge.caches_to_numpy(c_t)
    want = jax.tree_util.tree_map(np.asarray, c_j)
    assert len(got) == len(want)
    for g_t, g_j in zip(got, want):
        assert g_t.keys() == g_j.keys()
        for i in g_t:
            assert g_t[i].keys() == g_j[i].keys()
            for k in g_t[i]:
                if k == "pos":
                    np.testing.assert_array_equal(g_t[i][k], g_j[i][k])
                else:
                    _close(g_t[i][k], g_j[i][k])


@pytest.mark.parametrize("s", PROMPTS)
@pytest.mark.parametrize("wire", list(WIRES))
def test_split_session_matches_reference(setup, wire, s):
    """Tokens, wire records and bytes per token equal to the JAX
    session's; after prefill, the client's caches allclose, and the
    server's for the dense wire (an int8 hop may round an element of the
    cut activation the other way when the client halves differ in their
    last bits)."""
    js, ts = _sessions(setup, WIRES[wire], s)
    prompt = setup[-1][s]
    want = np.asarray(js.generate(jnp.asarray(prompt), GEN))
    got = ts.generate(torch.from_numpy(prompt), GEN)
    assert got.shape == (B, GEN)
    assert got.tolist() == want.tolist()
    assert _records(ts.decode_cost(1)) == _jrecords(js.decode_cost(1))
    assert _records(ts.prefill_cost(B, s)) == _jrecords(js.prefill_cost(B, s))
    assert ts.bytes_per_token() == js.bytes_per_token() == \
        (128 + 4 + 97 + 4 if wire != "dense" else 4 * (128 + 97))
    js.prefill(jnp.asarray(prompt))
    ts.prefill(torch.from_numpy(prompt))
    _check_caches(ts._cc, js._cc)
    if wire == "dense":
        _check_caches(ts._sc, js._sc)


def test_packed_cut_payload_is_the_reference_payload_bitwise(setup):
    """The client half's cut activation, fed the same prompt, packs to the
    reference's int8 q and row scales bitwise."""
    from repro.core import wire_compress as jwc
    cfg_j, params_j, cfg_t, params_t, prompts = setup
    js, ts = _sessions(setup, WIRES["physical_q8"], 19)
    prompt = prompts[19]
    cc_j, _ = js.model.init_cache_split(B, 27, js.cut)
    act_j, _ = js.model.prefill_client(js.client_params,
                                       {"tokens": jnp.asarray(prompt)},
                                       js.cut, cc_j)
    # the same activation on both sides, so the packing alone is compared
    act = np.array(act_j)
    p_t = pack_int8(torch.from_numpy(act))
    p_j = jwc.pack_int8(jnp.asarray(act))
    np.testing.assert_array_equal(p_t.q.numpy(), np.asarray(p_j.q))
    np.testing.assert_array_equal(p_t.scale.numpy(), np.asarray(p_j.scale))
    cc_t, _ = ts.model.init_cache_split(B, 27, ts.cut)
    with torch.no_grad():
        act_t, _ = ts.model.prefill_client(
            ts.client_params, {"tokens": torch.from_numpy(prompt)}, ts.cut,
            cc_t)
    _close(act_t, act)


def _halves_logits(model, cp, sp, cut, prompt, caches):
    """Last-position logits of one prefill, or of the decode loop over
    the prompt when `caches` is given (fresh caches)."""
    cc, sc = caches
    if cc is None:
        cc, sc = model.init_cache_split(B, 32, cut)
        act, cc = model.prefill_client(cp, {"tokens": prompt}, cut, cc)
        logits, sc = model.prefill_server(sp, act, cut, sc)
        return logits[:, -1], cc, sc
    for t in range(prompt.shape[1]):
        act, cc = model.decode_step_client(cp, prompt[:, t:t + 1], cut, cc)
        logits, sc = model.decode_step_server(sp, act, cut, sc)
    return logits[:, -1], cc, sc


@pytest.mark.parametrize("s", PROMPTS)
def test_prefill_matches_decode_loop(setup, s):
    """ONE prefill == the O(S) decode_step loop: last-position logits at
    1e-4 and the greedy continuation token for token, through the split
    halves (the RG-LRU state and the windowed ring carry over)."""
    _, _, cfg_t, params_t, prompts = setup
    ts = ServeSession(ServePlan(arch=cfg_t, max_batch=B, max_len=32),
                      params_t, device="cpu")
    m, cut, cp, sp = ts.model, ts.cut, ts.client_params, ts.server_params
    prompt = torch.from_numpy(prompts[s])
    with torch.no_grad():
        l_p, cc_p, sc_p = _halves_logits(m, cp, sp, cut, prompt, (None, None))
        l_l, cc_l, sc_l = _halves_logits(m, cp, sp, cut, prompt,
                                         m.init_cache_split(B, 32, cut))
    np.testing.assert_allclose(l_l.numpy(), l_p.numpy(), rtol=1e-4,
                               atol=1e-4)
    tok = torch.argmax(l_p, -1)[:, None]
    runs = []
    for cc, sc in ((cc_l, sc_l), (cc_p, sc_p)):
        ts._cc, ts._sc = cc, sc
        runs.append(ts.decode(tok, GEN).tolist())
    assert runs[0] == runs[1]


def test_fused_entry_needs_an_attention_entry(setup):
    cfg_t, params_t = setup[2], setup[3]
    with pytest.raises(ValueError, match="fused_entry"):
        ServeSession(ServePlan(arch=cfg_t, max_batch=B, max_len=16,
                               wire="quantize_int8:physical",
                               fused_entry=True), params_t, device="cpu")


def test_cpu_serving_launches_no_kernel(setup):
    _, ts = _sessions(setup, WIRES["physical_q8"], 19)
    ops.reset_launches()
    ts.generate(torch.from_numpy(setup[-1][19]), 3)
    ts.decode_cost(B)
    ts.prefill_cost(B, 19)
    assert sum(ops.launch_counts().values()) == 0


def test_full_width_wire_bytes_on_meta():
    """The full-width model (26 layers, d_model 2560, vocab 256,000,
    untied head, bf16) on meta tensors: 2,564 B up and 256,004 B down
    per generated token per row."""
    cfg = get_config("recurrentgemma_2b")
    model = build_model(cfg)
    params = model.init(torch.Generator(), "meta")
    blk = params["groups"][0][0]
    assert blk["0"]["mixer"]["lam"].dtype == torch.float32
    assert tuple(blk["0"]["mixer"]["conv"]["w"].shape) == (4, 2560, 2560)
    assert tuple(blk["2"]["mixer"]["wk"]["w"].shape) == (2560, 256)
    assert tuple(params["head"]["w"].shape) == (2560, 256000)
    ts = ServeSession(ServePlan(arch=cfg, max_batch=4, max_len=4129,
                                wire="quantize_int8:physical"), params,
                      device="meta")
    assert tuple(ts._meta_weights()[1]["groups"][0][0]["2"]["mixer"]["wq"]
                 ["w"].shape) == (2560, 2560)
    cost = ts.decode_cost(4)
    assert cost.bytes_up == 4 * (2560 + 4) and cost.bytes_down == 4 * 256004
    assert ts.bytes_per_token() == 258568
    assert all(w.physical for w in cost.wires)
    cc, sc = model.init_cache_split(4, 4129, 3, "meta")
    assert tuple(sc[0][0]["2"]["k"].shape) == (4, 2048, 1, 256)


def test_bridge_carries_composite_groups_and_hybrid_caches():
    """In a bf16 model `lam` stays float32 across the bridge and the
    composite group's params and the hybrid caches (RG-LRU conv and h,
    the ring's k, v and pos) round-trip exactly."""
    red = dict(RED, dtype=jnp.bfloat16)
    cfg_j = jget_config("recurrentgemma_2b").reduced(**red)
    params_j = jbuild_model(cfg_j).init(jax.random.PRNGKey(0))
    np_j = jax.tree_util.tree_map(np.asarray, params_j)
    cfg_t = get_config("recurrentgemma_2b").reduced(
        **dict(RED, dtype=torch.bfloat16))
    params_t = bridge.params_from_jax(np_j, cfg_t)
    rep = params_t["groups"][0][1]
    assert sorted(rep) == ["0", "1", "2"] and len(params_t["groups"][0]) == 2
    assert rep["1"]["mixer"]["lam"].dtype == torch.float32
    assert rep["1"]["mixer"]["in_x"]["w"].dtype == torch.bfloat16
    assert rep["2"]["mixer"]["wq"]["w"].dtype == torch.bfloat16
    back = bridge.params_to_numpy(params_t)
    for a, b in zip(jax.tree_util.tree_leaves(np_j),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    m = jbuild_model(cfg_j)
    cc_j, sc_j = m.init_cache_split(B, 16, 3)
    sc_j = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 1).astype(np.asarray(a).dtype), sc_j)
    sc_t = bridge.caches_from_jax(sc_j)
    c = sc_t[0][0]
    assert c["0"]["h"].dtype == torch.float32
    assert c["0"]["conv"].dtype == torch.bfloat16
    assert c["2"]["k"].dtype == torch.bfloat16 and c["2"]["pos"] == 1
    for a, b in zip(jax.tree_util.tree_leaves(sc_j),
                    jax.tree_util.tree_leaves(bridge.caches_to_numpy(sc_t))):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def test_serve_cli_serves_recurrentgemma_on_cpu(capsys):
    tlaunch.main(["--arch", "recurrentgemma_2b", "--reduced", "--split",
                  "--wire", "quantize_int8:physical", "--batch", "2",
                  "--prompt-len", "70", "--gen", "4", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["arch"] == "recurrentgemma-2b" and summary["cut"] == 3
    assert summary["wire_bytes_per_token"] == 128 + 4 + 256 + 4
    assert len(summary["sample_tokens"]) == 4
