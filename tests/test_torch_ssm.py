"""The port's Mamba2 (SSM family) split serving against the JAX reference.

Reduced Mamba2-130M (2 layers, d_model 128, 4 heads of 32, state 32,
chunk 8, vocab 97, fp32), the reference's parameters from PRNGKey(0)
bridged over, inputs drawn with numpy from a seed:

* softplus, the causal conv, `ssd_chunked` (with an initial state and
  the final state out), `ssd_decode_step`, and the Mamba2 mixer's
  apply / prefill (from a zero and from a carried cache) / decode:
  allclose at 1e-5 (the sums run in another order);
* the whole split `ServeSession` for the dense, fake-q8 and physical-q8
  wires at prompt 7 (one chunk of 7) and 11 (a chunk of 8 plus a
  remainder of 3 with the carried state): tokens equal to the JAX
  session's, `WireRecord`s and bytes per token equal record for record,
  caches after prefill at 1e-5;
* one prefill equals the O(S) decode loop (logits at 1e-4, greedy
  continuation token for token): the loop carries the state only if
  each block's returned cache is written back;
* the full-width configuration bills 772 + 50,284 = 51,056 wire bytes per
  generated token per row, counted on meta tensors.
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
from repro.nn import layers as JL
from repro.nn import ssm as JS
from repro.serve import ServePlan as JServePlan
from repro.serve import ServeSession as JServeSession
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build_model
from repro_torch.nn import layers as L
from repro_torch.nn import ssm as S
from repro_torch.serve import ServePlan, ServeSession

B, GEN = 2, 6
PROMPTS = (7, 11)              # one chunk; a chunk of 8 and a remainder
TOL = dict(rtol=1e-5, atol=1e-5)
WIRES = {"dense": "", "fake_q8": "quantize_int8",
         "physical_q8": "quantize_int8:physical"}


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _ssm_cfgs():
    """The reduced model's SSMConfig in both packages."""
    cfg = jget_config("mamba2_130m").reduced(vocab=97)
    kw = dict(d_model=cfg.d_model, d_inner=cfg.ssm_expand * cfg.d_model,
              head_dim=cfg.ssm_head_dim, d_state=cfg.ssm_state,
              n_groups=cfg.ssm_groups, chunk=cfg.ssm_chunk)
    return JS.SSMConfig(**kw), S.SSMConfig(**kw)


@pytest.fixture(scope="module")
def setup():
    cfg_j = jget_config("mamba2_130m").reduced(vocab=97)
    params_j = jbuild_model(cfg_j).init(jax.random.PRNGKey(0))
    cfg_t = get_config("mamba2_130m").reduced(vocab=97)
    params_t = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t)
    prompts = {s: np.array(jax.random.randint(jax.random.PRNGKey(1), (B, s),
                                              0, cfg_j.vocab))
               for s in PROMPTS}
    return cfg_j, params_j, cfg_t, params_t, prompts


@pytest.fixture(scope="module")
def mixer():
    """One Mamba2 mixer's params (reference init, bridged) and inputs."""
    jcfg, tcfg = _ssm_cfgs()
    pj = JS.mamba2_init(jax.random.PRNGKey(3), jcfg)
    pt = bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    # the reference inits dt_bias to 0 and D to 1: move them off those
    rng = np.random.default_rng(4)
    H = jcfg.n_heads
    for k, v in (("dt_bias", rng.standard_normal(H)),
                 ("D", 1 + 0.5 * rng.standard_normal(H))):
        pj[k] = jnp.asarray(v.astype(np.float32))
        pt[k] = torch.from_numpy(v.astype(np.float32))
    x = (0.5 * rng.standard_normal((B, 11, jcfg.d_model))).astype(np.float32)
    return jcfg, tcfg, pj, pt, x


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def test_softplus_matches_reference():
    """torch's softplus (threshold 20) against the reference's
    logaddexp(x, 0), through and past the threshold."""
    x = np.concatenate([np.linspace(-40, 40, 8001),
                        [19.99, 20.0, 20.01, 60.0, 1e4]]).astype(np.float32)
    got = F.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    assert np.array_equal(got[x >= 20], want[x >= 20])


def test_conv1d_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    p = {"w": (0.2 * rng.standard_normal((4, 24, 24))).astype(np.float32),
         "b": rng.standard_normal(24).astype(np.float32)}
    want = JL.conv1d_apply(jax.tree_util.tree_map(jnp.asarray, p),
                           jnp.asarray(x), padding="VALID")
    got = L.conv1d_apply(bridge.tree_from_jax(p), torch.from_numpy(x))
    assert tuple(got.shape) == (2, 6, 24)
    _close(got, want)
    w = L.conv1d_init(torch.Generator().manual_seed(0), 24, 16, 4)
    assert tuple(w["w"].shape) == (4, 24, 16) and tuple(w["b"].shape) == (16,)


def _ssd_inputs(seed, b, s, h, g, p, n):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, s, h, p))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = -np.exp(0.2 * rng.standard_normal(h)).astype(np.float32)
    Bm = (0.3 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    Cm = (0.3 * rng.standard_normal((b, s, g, n))).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return (x, dt, A, Bm, Cm), init


@pytest.mark.parametrize("chunk", [8, 24])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_ssd_chunked_matches_reference(chunk, carried):
    args, init = _ssd_inputs(6, 2, 24, 4, 2, 8, 16)
    init = init if carried else None
    y_j, st_j = JS.ssd_chunked(
        *map(jnp.asarray, args), chunk=chunk, return_state=True,
        initial_state=None if init is None else jnp.asarray(init))
    y_t, st_t = S.ssd_chunked(
        *map(torch.from_numpy, args), chunk=chunk, return_state=True,
        initial_state=None if init is None else torch.from_numpy(init))
    _close(y_t, y_j)
    _close(st_t, st_j)
    # without return_state, y alone
    _close(S.ssd_chunked(*map(torch.from_numpy, args), chunk=chunk,
                         initial_state=None if init is None
                         else torch.from_numpy(init)), y_j)


def test_ssd_decode_step_matches_reference():
    (x, dt, A, Bm, Cm), init = _ssd_inputs(7, 2, 1, 4, 2, 8, 16)
    st_j, y_j = JS.ssd_decode_step(jnp.asarray(init), jnp.asarray(x[:, 0]),
                                   jnp.asarray(dt[:, 0]), jnp.asarray(A),
                                   jnp.asarray(Bm[:, 0]),
                                   jnp.asarray(Cm[:, 0]))
    t = torch.from_numpy
    st_t, y_t = S.ssd_decode_step(t(init), t(x[:, 0]), t(dt[:, 0]), t(A),
                                  t(Bm[:, 0]), t(Cm[:, 0]))
    _close(st_t, st_j)
    _close(y_t, y_j)


def _jcache(cache):
    return jax.tree_util.tree_map(jnp.asarray, cache)


@pytest.mark.parametrize("step", ["apply", "prefill_zero", "prefill_carried",
                                  "decode"])
def test_mamba2_mixer_matches_reference(mixer, step):
    jcfg, tcfg, pj, pt, x = mixer
    rng = np.random.default_rng(8)
    carried = {"conv": (0.5 * rng.standard_normal(
                   (B, jcfg.d_conv - 1,
                    jcfg.d_inner + 2 * jcfg.n_groups * jcfg.d_state))
               ).astype(np.float32),
               "ssm": rng.standard_normal(
                   (B, jcfg.n_heads, jcfg.head_dim, jcfg.d_state)
               ).astype(np.float32)}
    if step == "apply":        # one chunk of 8 (apply asserts S % chunk)
        _close(S.mamba2_apply(pt, tcfg, torch.from_numpy(x[:, :8])),
               JS.mamba2_apply(pj, jcfg, jnp.asarray(x[:, :8])))
        return
    if step == "prefill_zero":
        cache = {k: np.asarray(v)
                 for k, v in JS.mamba2_init_cache(jcfg, B).items()}
        assert all(np.array_equal(S.mamba2_init_cache(tcfg, B)[k].numpy(), v)
                   for k, v in cache.items())
    else:
        cache = carried
    fn_j = JS.mamba2_decode if step == "decode" else JS.mamba2_prefill
    fn_t = S.mamba2_decode if step == "decode" else S.mamba2_prefill
    xin = x[:, :1] if step == "decode" else x
    y_j, c_j = fn_j(pj, jcfg, jnp.asarray(xin), _jcache(cache))
    y_t, c_t = fn_t(pt, tcfg, torch.from_numpy(xin),
                    bridge.tree_from_jax(cache))
    _close(y_t, y_j)
    for k in ("conv", "ssm"):
        assert tuple(c_t[k].shape) == tuple(np.shape(c_j[k]))
        _close(c_t[k], c_j[k])


def test_scan_inputs_fit_the_kernel_layout(mixer, monkeypatch):
    """What the Mamba2 prefill hands the SSD scan (views into the conv
    output) is laid out as the CUDA kernel reads it: dense past the
    sequence axis, one stride per token."""
    from repro_torch.kernels import ssd_scan as K
    _, tcfg, _, pt, x = mixer
    seen, plain = [], K.ssd_chunked_plain

    def spy(*args, **kw):
        seen.append(args)
        return plain(*args, **kw)
    monkeypatch.setattr(K, "ssd_chunked_plain", spy)
    S.mamba2_prefill(pt, tcfg, torch.from_numpy(x),
                     S.mamba2_init_cache(tcfg, B))
    assert len(seen) == 2                       # a chunk and a remainder
    for xs, dt, _, Bm, Cm in seen:
        H, P, G, N = (*xs.shape[2:], *Bm.shape[2:])
        for t, inner in ((xs, (H, P)), (dt, (H,)), (Bm, (G, N)),
                         (Cm, (G, N))):
            K._token_strides(t, inner, "input")
    with pytest.raises(ValueError, match="not dense"):
        K._token_strides(seen[0][0].transpose(2, 3), (P, H), "x")


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


@pytest.mark.parametrize("s", PROMPTS)
@pytest.mark.parametrize("wire", list(WIRES))
def test_split_session_matches_reference(setup, wire, s):
    """Tokens, wire records and bytes per token equal to the JAX
    session's; after prefill, the client's caches allclose, and the
    server's for the dense wire (an int8 hop may round an element of the
    cut activation the other way when the client halves differ in their
    last bits, which moves the server's state by a quantization step)."""
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
    sides = [(ts._cc, js._cc)] + ([(ts._sc, js._sc)] if wire == "dense"
                                  else [])
    for c_t, c_j in sides:
        got_c = bridge.caches_to_numpy(c_t)
        want_c = jax.tree_util.tree_map(np.asarray, c_j)
        for g_t, g_j in zip(got_c, want_c):
            for k in ("conv", "ssm"):
                _close(g_t["0"][k], g_j["0"][k])


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
    1e-4 and the greedy continuation token for token (the port's
    counterpart of tests/test_serve.py::test_prefill_matches_decode_loop
    for the SSM arch, through the split halves)."""
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
    _, ts = _sessions(setup, WIRES["physical_q8"], 11)
    ops.reset_launches()
    ts.generate(torch.from_numpy(setup[-1][11]), 3)
    ts.decode_cost(B)
    assert sum(ops.launch_counts().values()) == 0


def test_full_width_wire_bytes_on_meta():
    """The full-width model (24 layers, vocab 50,280, bf16) on meta
    tensors: 772 B up and 50,284 B down per generated token per row."""
    cfg = get_config("mamba2_130m")
    model = build_model(cfg)
    with torch.device("meta"):
        params = model.init(torch.Generator(), "meta")
    assert params["groups"][0][0]["0"]["mixer"]["A_log"].dtype == \
        torch.float32
    assert params["groups"][0][0]["0"]["mixer"]["conv"]["w"].shape == \
        (4, 1792, 1792)
    ts = ServeSession(ServePlan(arch=cfg, max_batch=4, max_len=545,
                                wire="quantize_int8:physical"), params,
                      device="meta")
    cost = ts.decode_cost(4)
    assert cost.bytes_up == 4 * (768 + 4) and cost.bytes_down == 4 * 50284
    assert ts.bytes_per_token() == 51056
    assert all(w.physical for w in cost.wires)


def test_bridge_keeps_ssm_leaves_float32():
    """In a bf16 model, A_log / D / dt_bias stay float32 across the
    bridge, the conv keeps its (k, C, C) layout, and the round trip is
    exact."""
    cfg_j = jget_config("mamba2_130m").reduced(vocab=97, dtype=jnp.bfloat16)
    params_j = jbuild_model(cfg_j).init(jax.random.PRNGKey(0))
    np_j = jax.tree_util.tree_map(np.asarray, params_j)
    cfg_t = get_config("mamba2_130m").reduced(vocab=97, dtype=torch.bfloat16)
    params_t = bridge.params_from_jax(np_j, cfg_t)
    mix = params_t["groups"][0][1]["0"]["mixer"]
    assert {k: mix[k].dtype for k in ("A_log", "D", "dt_bias")} == \
        dict.fromkeys(("A_log", "D", "dt_bias"), torch.float32)
    assert mix["in_proj"]["w"].dtype == torch.bfloat16
    assert tuple(mix["conv"]["w"].shape) == (4, 320, 320)
    back = bridge.params_to_numpy(params_t)
    for a, b in zip(jax.tree_util.tree_leaves(np_j),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    # the reference's split caches carry across and back
    m = jbuild_model(cfg_j)
    cc_j, sc_j = m.init_cache_split(B, 16, 1)
    cc_j = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 1).astype(np.asarray(a).dtype), cc_j)
    cc_t = bridge.caches_from_jax(cc_j)
    assert cc_t[0][0]["0"]["ssm"].dtype == torch.float32
    assert cc_t[0][0]["0"]["conv"].dtype == torch.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves(cc_j),
                    jax.tree_util.tree_leaves(bridge.caches_to_numpy(cc_t))):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def test_serve_cli_serves_mamba2_on_cpu(capsys):
    tlaunch.main(["--arch", "mamba2_130m", "--reduced", "--split", "--wire",
                  "quantize_int8:physical", "--batch", "2", "--prompt-len",
                  "11", "--gen", "4", "--device", "cpu"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["arch"] == "mamba2-130m" and summary["cut"] == 1
    assert summary["wire_bytes_per_token"] == 128 + 4 + 256 + 4
    assert len(summary["sample_tokens"]) == 4
