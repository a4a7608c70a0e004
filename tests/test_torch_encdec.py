"""The port's encoder-decoder family (`repro_torch.models.encdec`, Whisper)
against the JAX reference (`repro.models.encdec`), on the CPU.

Reduced Whisper-base (2 encoder and 2 decoder layers, d_model 128, 4
query heads over 2 KV heads of 32, 16 audio frames, vocab 97, fp32), the
reference's parameters from PRNGKey(0) bridged over; token ids, frames
and activations are seeded numpy arrays handed to both.

* the pieces: `layernorm_apply` (scale and bias drawn, not the init's
  ones and zeros), the bidirectional `gqa_apply` of an encoder layer (no
  rope, no mask: the flash kernel's non-causal mode on a card, its plain
  version here), `cross_attn_kv` and `cross_attn_apply`;
* `sinusoidal_positions` at Whisper's full 1,500 x 512 and at a decode
  offset;
* `encode`, `forward` and `loss`, and the loss's gradient over the whole
  tree;
* `init_cache` + `prefill` + `decode_step`: logits and caches, and the
  greedy tokens; prefill agrees with a decode loop and with `decode_full`
  re-run teacher-forced over the generated prefix;
* `input_specs`, the serve CLI's monolithic run on `--device cpu`, the
  refusal of split serving, and the training CLI's monolithic and fedavg
  runs (the reference CLI's JSON keys) with `--mode split` refused.

Tolerances: values at rtol = atol = 1e-5 (the two frameworks sum matmuls
in other orders); gradients at rtol 1e-4, atol 1e-5 x the leaf's largest
(a backward sums over the batch and the sequence, as
`tests/test_torch_lm_train.py` states), but the key bias's, which is 0
in exact arithmetic, below 1e-6 of the tree's largest in both; the
sinusoids within 4 float32
ulps of the largest angle (XLA's `pow` and torch's may part by an ulp,
and the sine carries the angle's error); tokens bitwise.

The gpu-marked case holds the flash kernel's non-causal mode at
Whisper's encoder shape against its plain version on the card, and
skips here.
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
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.models import input_specs as jinput_specs
from repro.nn import attention as JA
from repro.nn import layers as JL
from repro_torch import bridge
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model, input_specs
from repro_torch.models import encdec as tencdec
from repro_torch.models import supports_split_serving
from repro_torch.nn import attention as TA
from repro_torch.nn import layers as TL
from repro_torch.nn import module as tmod
from repro_torch.serve import ServePlan, ServeSession, greedy_decode_scan
from _torch_threads import one_torch_thread

one_torch_thread()

ARCH = "whisper_base"
B, S, GEN = 2, 7, 5
MAX_LEN = S + GEN + 1
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """(jax cfg, jax model, jax params, port cfg, port model, port params,
    tokens, audio)"""
    cfg_j = jget_config(ARCH).reduced(vocab=97)
    mj = jbuild_model(cfg_j)
    pj = mj.init(jax.random.PRNGKey(0))
    cfg_t = get_config(ARCH).reduced(vocab=97)
    mt = build_model(cfg_t)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                cfg_t)
    tokens = np.random.default_rng(1).integers(0, 97, (B, S))
    audio = _x(2, (B, cfg_t.n_audio_frames, cfg_t.d_model), 0.02)
    return cfg_j, mj, pj, cfg_t, mt, pt, tokens, audio


def _layer(tree, i=0):
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def test_config_and_params_bridge(setup):
    cfg_j, mj, pj, cfg_t, mt, pt, _, _ = setup
    assert str(get_config(ARCH).dtype) == "torch.bfloat16"
    assert isinstance(mt, tencdec.EncDec)
    assert len(pt["enc_blocks"]) == cfg_t.n_enc_layers == 2
    assert len(pt["dec_blocks"]) == cfg_t.n_layers == 2
    # the port's own init has the reference's tree, shapes and dtypes
    mine = bridge.params_to_numpy(mt.init(torch.Generator().manual_seed(0),
                                          "cpu"))
    assert jax.tree_util.tree_structure(mine) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, pj))
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(pj)):
        assert a.shape == b.shape
    # and the bridge carries the reference's tree back bitwise
    back = bridge.params_to_numpy(pt)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(pj), strict=True):
        np.testing.assert_array_equal(a, np.asarray(b))
    # restacked as the checkpoints write it
    stacked = bridge.lm_tree_to_ref(pt)
    assert tuple(stacked["dec_blocks"]["mlp"]["fc1"]["w"].shape) == \
        pj["dec_blocks"]["mlp"]["fc1"]["w"].shape
    again = bridge.lm_tree_from_ref(stacked)
    assert all(torch.equal(a, b) for a, b in zip(
        tmod.tree_leaves(again), tmod.tree_leaves(pt), strict=True))


def test_layernorm_matches_reference():
    x = _x(3, (B, S, 128), 3.0) + 1.5
    params = {"scale": _x(4, (128,)), "bias": _x(5, (128,))}
    got = TL.layernorm_apply({k: torch.from_numpy(v)
                              for k, v in params.items()},
                             torch.from_numpy(x))
    _close(got, JL.layernorm_apply({k: jnp.asarray(v)
                                    for k, v in params.items()},
                                   jnp.asarray(x)))
    assert TL.layernorm_apply(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x).to(torch.bfloat16)).dtype == torch.bfloat16


def test_bidir_and_cross_attention_match_reference(setup):
    _, mj, pj, _, mt, pt, _, _ = setup
    x = _x(6, (B, S, 128))
    enc = _x(7, (B, 16, 128))
    # an encoder layer's attention: bidirectional, no rope
    ac_j, ac_t = mj._enc_spec().attn, mt._enc_spec().attn
    assert ac_t.kind == "bidir"
    a_j = _layer(pj["enc_blocks"])["mixer"]
    a_t = pt["enc_blocks"][0]["mixer"]
    before = ops.launch_counts()
    _close(TA.gqa_apply(a_t, ac_t, torch.from_numpy(x)),
           JA.gqa_apply(a_j, ac_j, jnp.asarray(x)))
    assert ops.launch_counts() == before          # the plain version here
    # its plain version is non-causal flash attention
    q, k, v = TA._qkv(a_t, ac_t, torch.from_numpy(x))
    seen = []
    real = ops.flash_attention

    def spy(*args, **kw):
        seen.append(kw)
        return real(*args, **kw)
    ops.flash_attention = spy
    try:
        TA.gqa_apply(a_t, ac_t, torch.from_numpy(x))
    finally:
        ops.flash_attention = real
    assert [(s["causal"], s["window"]) for s in seen] == [(False, None)]
    _close(ref.flash_attention_ref(q, k, v, causal=False),
           ref.grouped_attention(q, k, v, torch.ones((S, S), dtype=bool),
                                 scale=32 ** -0.5))
    # a decoder layer's cross-attention over the encoder's states
    dj, dt = _layer(pj["dec_blocks"], 1), pt["dec_blocks"][1]
    cj, ct = mj._dec_attn_cfg(), mt._dec_attn_cfg()
    kv_j = JA.cross_attn_kv(dj["cross_attn"], cj, jnp.asarray(enc))
    kv_t = TA.cross_attn_kv(dt["cross_attn"], ct, torch.from_numpy(enc))
    for key in ("k", "v"):
        _close(kv_t[key], kv_j[key])
    _close(TA.cross_attn_apply(dt["cross_attn"], ct, torch.from_numpy(x),
                               kv_t),
           JA.cross_attn_apply(dj["cross_attn"], cj, jnp.asarray(x), kv_j))


@pytest.mark.parametrize("n,d,offset", [(1500, 512, 0), (1, 512, 1499),
                                        (16, 128, 0)])
def test_sinusoidal_positions_match_reference(n, d, offset):
    got = tencdec.sinusoidal_positions(n, d, offset)
    want = np.asarray(jencdec.sinusoidal_positions(n, d, offset))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * (n + offset) * 2.0 ** -23)


def test_encode_forward_loss_and_grad_match_reference(setup):
    _, mj, pj, _, mt, pt, tokens, audio = setup
    labels = np.random.default_rng(8).integers(0, 97, (B, S))
    bj = {"audio_feats": jnp.asarray(audio), "tokens": jnp.asarray(tokens),
          "labels": jnp.asarray(labels)}
    bt = {"audio_feats": torch.from_numpy(audio),
          "tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    _close(mt.encode(pt, bt["audio_feats"]), mj.encode(pj, bj["audio_feats"]))
    _close(mt.forward(pt, bt), mj.forward(pj, bj))
    lj, gj = jax.jit(jax.value_and_grad(lambda p: mj.loss(p, bj)))(pj)
    leaves = tmod.tree_map(lambda t: t.detach().clone().requires_grad_(), pt)
    lt = mt.loss(leaves, bt)
    lt.backward()
    _close(lt, lj)
    gt = bridge.params_to_numpy(tmod.tree_map(lambda t: t.grad, leaves))
    flat_t, _ = jax.tree_util.tree_flatten_with_path(gt)
    flat_j = jax.tree_util.tree_leaves(gj)
    top = max(float(np.abs(b).max()) for b in flat_j)
    for (path, a), b in zip(flat_t, flat_j, strict=True):
        b = np.asarray(b)
        if "wk" in jax.tree_util.keystr(path) and a.ndim == 2:
            # the key bias: a softmax is invariant to a shift of a row's
            # scores, so its gradient is 0 in exact arithmetic and rounding
            # noise in both packages
            assert np.abs(a).max() <= 1e-6 * top >= np.abs(b).max()
            continue
        np.testing.assert_allclose(
            a, b, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(float(np.abs(b).max()), 1e-30))


def _greedy_j(mj, pj, tokens, audio):
    cache = mj.init_cache(pj, jnp.asarray(audio), MAX_LEN)
    logits, cache = jax.jit(mj.prefill)(pj, jnp.asarray(tokens), cache)
    tok = jnp.argmax(logits[:, -1], -1)[:, None]
    step = jax.jit(mj.decode_step)
    toks, step_logits = [tok], []
    for _ in range(GEN - 1):
        lg, cache = step(pj, tok, cache)
        step_logits.append(lg)
        tok = jnp.argmax(lg[:, -1], -1)[:, None]
        toks.append(tok)
    return logits, step_logits, jnp.concatenate(toks, 1), cache


def test_cache_prefill_and_decode_match_reference(setup):
    """Prefill logits, each decode step's logits, the greedy tokens and the
    final caches (cross K/V, rings, pos) against the reference."""
    _, mj, pj, _, mt, pt, tokens, audio = setup
    lj, steps_j, toks_j, cache_j = _greedy_j(mj, pj, tokens, audio)
    cache = mt.init_cache(pt, torch.from_numpy(audio), MAX_LEN)
    assert cache["pos"] == 0
    lt, cache = mt.prefill(pt, torch.from_numpy(tokens), cache)
    assert cache["pos"] == S
    _close(lt, lj)
    tok = torch.argmax(lt[:, -1], -1)[:, None]
    toks = [tok]
    for want in steps_j:
        lg, cache = mt.decode_step(pt, tok, cache)
        _close(lg, want)
        tok = torch.argmax(lg[:, -1], -1)[:, None]
        toks.append(tok)
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(),
                                  np.asarray(toks_j))
    assert cache["pos"] == int(cache_j["pos"]) == S + GEN - 1
    for part in ("cross", "self"):
        for key in ("k", "v"):
            _close(cache[part][key], cache_j[part][key])
    # greedy_decode_scan (the serve CLI's decode) over the port's cache
    cache = mt.init_cache(pt, torch.from_numpy(audio), MAX_LEN)
    lt, cache = mt.prefill(pt, torch.from_numpy(tokens), cache)
    tok0 = torch.argmax(lt[:, -1], -1)[:, None]
    rest, _ = greedy_decode_scan(mt, pt, cache, tok0, GEN - 1)
    np.testing.assert_array_equal(torch.cat([tok0, rest], 1).numpy(),
                                  np.asarray(toks_j))


def test_prefill_agrees_with_decode_loop_and_decode_full(setup):
    """The reference's `test_prefill_matches_decode_loop_encdec` in the
    port, plus the teacher-forced check the card runs at full size: the
    greedy tokens equal the argmax of `decode_full` over the prompt and
    the tokens generated before each."""
    _, _, _, _, mt, pt, tokens, audio = setup
    a = torch.from_numpy(audio)
    t = torch.from_numpy(tokens)
    cache_l = mt.init_cache(pt, a, MAX_LEN)
    for i in range(S):
        logits_l, cache_l = mt.decode_step(pt, t[:, i:i + 1], cache_l)
    cache_p = mt.init_cache(pt, a, MAX_LEN)
    logits_p, cache_p = mt.prefill(pt, t, cache_p)
    _close(logits_l[:, -1], logits_p[:, -1], dict(rtol=1e-4, atol=1e-4))
    tok = torch.argmax(logits_p[:, -1], -1)[:, None]
    x, _ = greedy_decode_scan(mt, pt, cache_l, tok, GEN)
    y, _ = greedy_decode_scan(mt, pt, cache_p, tok, GEN)
    assert torch.equal(x, y)
    gen = torch.cat([tok, y[:, :GEN - 1]], 1)
    full = mt.decode_full(pt, torch.cat([t, gen], 1), mt.encode(pt, a))
    assert torch.equal(torch.argmax(full[:, S - 1:-1], -1), gen)


def test_input_specs_match_reference():
    cfg_j, cfg_t = jget_config(ARCH), get_config(ARCH)
    for name, shape in INPUT_SHAPES.items():
        want = jinput_specs(cfg_j, JINPUT_SHAPES[name])
        got = input_specs(cfg_t, shape)
        assert set(got) == set(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape, (name, k)
            assert (t.dtype == torch.long) == (want[k].dtype == jnp.int32)
    assert tuple(input_specs(cfg_t, INPUT_SHAPES["train_4k"])[
        "tokens"].shape) == (256, 448)


def test_split_serving_refused(setup):
    cfg_t, pt = setup[3], setup[5]
    ok, why = supports_split_serving(cfg_t)
    assert not ok and "monolithic" in why
    with pytest.raises(ValueError, match="monolithic"):
        ServeSession(ServePlan(arch=cfg_t, max_batch=1, max_len=MAX_LEN), pt,
                     device="cpu")
    with pytest.raises(SystemExit, match="monolithic"):
        tserve.main(["--arch", ARCH, "--reduced", "--split", "--device",
                     "cpu"])


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_serve_cli_monolithic_on_cpu(monkeypatch, capsys):
    """The serve CLI serves Whisper monolithically with the reference
    CLI's JSON keys (plus `device`)."""
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "6",
            "--gen", "4"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    sj = _last_json(capsys.readouterr().out)
    run = tserve.main(argv + ["--device", "cpu"])
    st = _last_json(capsys.readouterr().out)
    assert list(st) == ["arch", "batch", "prompt_len", "generated", "device",
                        *[k for k in sj if k not in ("arch", "batch",
                                                     "prompt_len",
                                                     "generated")]]
    assert st["mode"] == sj["mode"] == "monolithic"
    assert st["arch"] == "whisper-base" and st["device"] == "cpu"
    assert tuple(run.tokens.shape) == (2, 4)
    assert bool(((run.tokens >= 0) & (run.tokens < 256)).all())


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
    assert tuple(batch["audio_feats"].shape) == (2, 16, 128)
    assert tuple(batch["tokens"].shape) == (2, 8)


def test_train_cli_refuses_split():
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        ttrain.main(["--arch", ARCH, "--reduced", "--steps", "1", "--mode",
                     "split", "--device", "cpu"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_non_causal_flash_on_card(cuda, dtype):
    """Whisper's encoder attention (4,1500,8,64): 1,500 rows leave 28 of
    the last 64-row KV tile real.  fp32 within rtol = atol = 2e-5 of the
    plain version; bf16 within 2 bf16 ulps of the float32 plain result."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((4, 1500, 8, 64), generator=gen, device=cuda)
               for _ in range(3))
    want = ref.flash_attention_ref(q, k, v, causal=False)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    got = ops.flash_attention(q, k, v, causal=False)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                       causal=False)
        ulp = torch.maximum(want.abs(), want.square().mean().sqrt() / 256)
        ulp = torch.exp2(torch.floor(torch.log2(ulp)) - 7)
        assert bool(((got.float() - want).abs() <= 2 * ulp).all())
