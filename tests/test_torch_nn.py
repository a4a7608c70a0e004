"""The port's layers, attention, blocks and split LM against the JAX
reference, on the reduced phi4-mini config with the reference's
parameters bridged over (`repro_torch.bridge`).  Inputs are seeded numpy
arrays handed to both; everything is fp32 on the CPU and compared at
rtol=atol=1e-5 (the two frameworks sum matmuls in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import lm as jlm
from repro.nn import attention as JA
from repro.nn import layers as JL
from repro.nn import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import lm as tlm
from repro_torch.nn import attention as TA
from repro_torch.nn import layers as TL
from repro_torch.nn import transformer as TT

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, MAX_LEN = 2, 7, 15


@pytest.fixture(scope="module")
def ref():
    """(jax cfg, jax model, jax params, numpy params, port cfg, port params)"""
    cfg_j = jget_config("phi4_mini_3_8b").reduced(vocab=97)
    model_j = jbuild_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params_j)
    cfg_t = get_config("phi4_mini_3_8b").reduced(vocab=97)
    return (cfg_j, model_j, params_j, np_params, cfg_t,
            bridge.params_from_jax(np_params, cfg_t))


def _layer0(ref):
    _, _, params_j, _, _, params_t = ref
    pj = jax.tree_util.tree_map(lambda a: a[0], params_j["groups"][0]["0"])
    return pj, params_t["groups"][0][0]["0"]


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


@pytest.mark.parametrize("arch", ["phi4_mini_3_8b", "mamba2_130m",
                                  "recurrentgemma_2b", "qwen3_moe_30b_a3b",
                                  "deepseek_v2_236b"])
def test_config_fields_match_reference(arch):
    for t, j in ((get_config(arch), jget_config(arch)),
                 (get_config(arch).reduced(vocab=97),
                  jget_config(arch).reduced(vocab=97))):
        ft, fj = dataclasses.asdict(t), dataclasses.asdict(j)
        assert str(ft.pop("dtype")).replace("torch.", "") == \
            jnp.dtype(fj.pop("dtype")).name
        assert ft == fj


def test_unported_families_raise():
    """Whisper (encoder-decoder) and InternVL2 (VLM) are not ported: their
    configs are refused, and so is a model of either family."""
    for arch in ("whisper_base", "internvl2_2b"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            get_config(arch)
    base = get_config("phi4_mini_3_8b").reduced()
    with pytest.raises(NotImplementedError, match="VLM and audio"):
        build_model(dataclasses.replace(base, family="vlm", n_patches=8,
                                        vision_dim=64))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        build_model(dataclasses.replace(base, family="audio", encdec=True))


def test_layers_match_reference(ref):
    pj, pt = _layer0(ref)
    x = _x(0, (B, S, 128))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(TL.rmsnorm_apply(pt["norm1"], xt),
           JL.rmsnorm_apply(pj["norm1"], xj))
    _close(TL.dense_apply(pt["mixer"]["wq"], xt),
           JL.dense_apply(pj["mixer"]["wq"], xj))
    _close(TL.swiglu_apply(pt["mlp"], xt), JL.swiglu_apply(pj["mlp"], xj))
    _, _, params_j, _, _, params_t = ref
    ids = np.random.default_rng(1).integers(0, 97, (B, S))
    _close(TL.embedding_apply(params_t["embed"], torch.from_numpy(ids)),
           JL.embedding_apply(params_j["embed"], jnp.asarray(ids)))
    _close(TL.embedding_attend(params_t["embed"], xt),
           JL.embedding_attend(params_j["embed"], xj))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_mask_and_grouped_attention(fraction):
    x = _x(2, (B, S, 4, 32))
    pos = np.arange(3, 3 + S)
    _close(TA.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                         theta=10000.0, fraction=fraction),
           JA.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=10000.0,
                         fraction=fraction))
    for window in (None, 3):
        assert np.array_equal(
            TA.causal_mask(S, S + 2, window=window).numpy(),
            np.asarray(JA.causal_mask(S, S + 2, window=window)))
    q, k, v = _x(3, (B, S, 4, 32)), _x(4, (B, S, 2, 32)), _x(5, (B, S, 2, 32))
    mask = TA.causal_mask(S, S)
    _close(TA.grouped_attention(*map(torch.from_numpy, (q, k, v)), mask,
                                scale=0.17),
           JA.grouped_attention(*map(jnp.asarray, (q, k, v)),
                                jnp.asarray(mask.numpy()), scale=0.17))


def _cache_close(ct, cj):
    assert ct["pos"] == int(cj["pos"])
    _close(ct["k"], cj["k"])
    _close(ct["v"], cj["v"])


def test_gqa_prefill_then_decode_with_caches(ref):
    cfg_j, _, _, _, cfg_t, _ = ref
    acj, act = jlm._attn_cfg(cfg_j), tlm._attn_cfg(cfg_t)
    pj, pt = _layer0(ref)
    x = _x(6, (B, S, 128))
    cj = JA.gqa_init_cache(acj, B, MAX_LEN)
    ct = TA.gqa_init_cache(act, B, MAX_LEN)
    yj, cj = JA.gqa_prefill(pj["mixer"], acj, jnp.asarray(x), cj)
    yt, ct = TA.gqa_prefill(pt["mixer"], act, torch.from_numpy(x), ct)
    _close(yt, yj)
    _cache_close(ct, cj)
    for step in range(3):
        xs = _x(10 + step, (B, 1, 128))
        yj, cj = JA.gqa_decode(pj["mixer"], acj, jnp.asarray(xs), cj)
        yt, ct = TA.gqa_decode(pt["mixer"], act, torch.from_numpy(xs), ct)
        _close(yt, yj)
        _cache_close(ct, cj)
    # the fused entry hands in precomputed (q, k, v)
    xs = _x(20, (B, 1, 128))
    qkv = [_x(21 + i, (B, 1, w)) for i, w in enumerate((128, 64, 64))]
    yj, cj = JA.gqa_decode(pj["mixer"], acj, jnp.asarray(xs), cj,
                           qkv=tuple(map(jnp.asarray, qkv)))
    yt, ct = TA.gqa_decode(pt["mixer"], act, torch.from_numpy(xs), ct,
                           qkv=tuple(map(torch.from_numpy, qkv)))
    _close(yt, yj)
    _cache_close(ct, cj)


def test_block_prefill_and_decode(ref):
    cfg_j, model_j, _, _, cfg_t, _ = ref
    spec_j = model_j.groups[0].specs[0]
    spec_t = build_model(cfg_t).groups[0].specs[0]
    pj, pt = _layer0(ref)
    x = _x(30, (B, S, 128))
    cj = JT.block_init_cache(spec_j, B, MAX_LEN)
    ct = TT.block_init_cache(spec_t, B, MAX_LEN)
    hj, cj = JT.block_prefill(pj, spec_j, jnp.asarray(x), cj)
    ht, ct = TT.block_prefill(pt, spec_t, torch.from_numpy(x), ct)
    _close(ht, hj)
    _cache_close(ct, cj)
    xs = _x(31, (B, 1, 128))
    hj, cj = JT.block_decode(pj, spec_j, jnp.asarray(xs), cj)
    ht, ct = TT.block_decode(pt, spec_t, torch.from_numpy(xs), ct)
    _close(ht, hj)
    _cache_close(ct, cj)


def test_split_lm_halves_match_reference(ref):
    """Client prefill -> server prefill -> one decode step on each half,
    cut at 1 of the 2 layers."""
    cfg_j, model_j, params_j, _, cfg_t, params_t = ref
    model_t = build_model(cfg_t)
    assert model_t.flat_layers() == model_j.flat_layers() == 2
    cpj, spj = model_j.split_params(params_j, 1)
    cpt, spt = model_t.split_params(params_t, 1)
    assert spt["tied_head"] is cpt["embed"]          # shared, not copied
    assert [g.n_repeat for g in model_t._groups_for_range(1, "server")] == \
        [g.n_repeat for g in model_j._groups_for_range(1, "server")]
    ccj, scj = model_j.init_cache_split(B, MAX_LEN, 1)
    cct, sct = model_t.init_cache_split(B, MAX_LEN, 1)
    ids = np.random.default_rng(40).integers(0, 97, (B, S))
    aj, ccj = model_j.prefill_client(cpj, {"tokens": jnp.asarray(ids)}, 1,
                                     ccj)
    at, cct = model_t.prefill_client(cpt, {"tokens": torch.from_numpy(ids)},
                                     1, cct)
    _close(at, aj)
    lj, scj = model_j.prefill_server(spj, aj, 1, scj)
    lt, sct = model_t.prefill_server(spt, torch.from_numpy(np.array(aj)),
                                     1, sct)
    _close(lt, lj, dict(rtol=1e-4, atol=1e-4))
    tok = np.argmax(np.asarray(lj)[:, -1], -1)[:, None]
    aj, ccj = model_j.decode_step_client(cpj, jnp.asarray(tok), 1, ccj)
    at, cct = model_t.decode_step_client(cpt, torch.from_numpy(tok), 1, cct)
    _close(at, aj)
    lj, scj = model_j.decode_step_server(spj, aj, 1, scj)
    lt, sct = model_t.decode_step_server(spt, torch.from_numpy(
        np.array(aj)), 1, sct)
    _close(lt, lj, dict(rtol=1e-4, atol=1e-4))
    jc = jax.tree_util.tree_map(lambda a: a[0], scj[0]["0"])
    _cache_close(sct[0][0]["0"], jc)


def test_bridge_round_trip(ref):
    *_, np_params, cfg_t, params_t = ref
    back = bridge.params_to_numpy(params_t)
    flat_a = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b)
    # bf16 leaves cross exactly (numpy has no bf16: they come back fp32)
    cfg16 = dataclasses.replace(cfg_t, dtype=torch.bfloat16)
    p16 = bridge.params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(
            jnp.asarray(a, jnp.bfloat16)), np_params), cfg16)
    assert p16["embed"]["table"].dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(np_params["embed"]["table"],
                                  jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(bridge.params_to_numpy(p16)["embed"]["table"],
                          want)
