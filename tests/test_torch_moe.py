"""The port's MoE and MLA modules against the JAX reference.

Parameters come from the reference's init (PRNGKey), bridged over
(`repro_torch.bridge`); inputs are seeded numpy arrays handed to both.
Everything runs in fp32 on the CPU:

* `moe_apply` (4 experts, top-2) with no drops, with a capacity factor
  of 0.5 under which slots overflow and drop, and with a shared expert: the
  output allclose at rtol = atol = 1e-5 (the matmuls and the gate
  renormalisation sum in another order), `drop_fraction` exactly and the
  load-balance loss at 1e-6; the same shapes on meta tensors;
* `mla_apply` with and without the q LoRA, and `mla_prefill` then three
  `mla_decode` steps: outputs at 1e-5, the compressed caches with the
  reference's keys, shapes and dtypes and allclose values, `pos` equal;
* the plain flash version with a value head narrower than q/k (MLA's
  prefill) against the reference's `grouped_attention`, causal and
  windowed, at 1e-5;
* `LM.loss` of the reduced Qwen3-MoE and DeepSeek-V2 at 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.nn import attention as JA
from repro.nn import moe as JM
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.nn import attention as TA
from repro_torch.nn import moe as TM
from _torch_threads import one_torch_thread

one_torch_thread()

TOL = dict(rtol=1e-5, atol=1e-5)
B = 2


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


MOE_CASES = {"no_drops": dict(capacity_factor=1.25),
             "drops": dict(capacity_factor=0.5),
             "shared": dict(capacity_factor=1.25, n_shared=1)}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_reference(case):
    kw = dict(d_model=32, d_ff=48, n_experts=4, top_k=2, **MOE_CASES[case])
    jcfg, tcfg = JM.MoEConfig(**kw), TM.MoEConfig(**kw)
    pj = JM.moe_init(jax.random.PRNGKey(3), jcfg)
    pt = bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    assert pt["router"]["w"].dtype == torch.float32
    init = TM.moe_init(torch.Generator().manual_seed(0), tcfg)
    assert bridge.tree_to_numpy(init).keys() == pt.keys()
    assert {k: tuple(v.shape) for k, v in init.items() if k in
            ("gate", "up", "down")} == {"gate": (4, 32, 48),
                                        "up": (4, 32, 48),
                                        "down": (4, 48, 32)}
    x = _x(4, (B, 13, 32))
    y_j, aux_j = JM.moe_apply(pj, jcfg, jnp.asarray(x), return_aux=True)
    y_t, aux_t = TM.moe_apply(pt, tcfg, torch.from_numpy(x), return_aux=True)
    _close(y_t, y_j)
    _close(TM.moe_apply(pt, tcfg, torch.from_numpy(x)), y_j)
    assert float(aux_t["drop_fraction"]) == float(aux_j["drop_fraction"])
    assert (float(aux_t["drop_fraction"]) > 0) == (case == "drops")
    _close(aux_t["load_balance_loss"], aux_j["load_balance_loss"],
           dict(rtol=1e-6, atol=1e-6))
    meta = bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                "meta")
    y_m, aux_m = TM.moe_apply(meta, tcfg, torch.empty(B, 13, 32,
                                                       device="meta"),
                              return_aux=True)
    assert y_m.shape == (B, 13, 32) and aux_m["drop_fraction"].ndim == 0


MLA_KW = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=24, kind="mla",
              kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
              v_head_dim=16)


def _mla(q_lora_rank, seed=5):
    jcfg = JA.AttnConfig(q_lora_rank=q_lora_rank, **MLA_KW)
    tcfg = TA.AttnConfig(q_lora_rank=q_lora_rank, **MLA_KW)
    pj = JA.mla_init(jax.random.PRNGKey(seed), jcfg)
    pt = bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    return jcfg, tcfg, pj, pt


def _shapes(tree):
    return {k: {kk: tuple(np.shape(vv)) for kk, vv in v.items()}
            for k, v in tree.items()}


def test_mla_apply_matches_reference():
    """With the q LoRA (wq_a, q_norm, wq_b) and with a full-rank wq; the
    port's init has the reference's leaves and shapes."""
    x = _x(6, (B, 11, 64))
    for rank in (32, 0):
        jcfg, tcfg, pj, pt = _mla(rank)
        init = TA.mla_init(torch.Generator().manual_seed(0), tcfg)
        assert _shapes(init) == _shapes(pj)
        _close(TA.mla_apply(pt, tcfg, torch.from_numpy(x)),
               JA.mla_apply(pj, jcfg, jnp.asarray(x)))


def _cache_layout(c):
    """{key: (shape, dtype)} of an MLA cache, the port's `pos` as the
    reference's int32."""
    return {k: (tuple(np.shape(v)), np.asarray(v).dtype.name)
            for k, v in (bridge.tree_to_numpy(c)
                         if isinstance(c["pos"], int) else c).items()}


def test_mla_prefill_then_decode_matches_reference():
    """Prefill a 9-row prompt into a 16-row cache, then decode 3 tokens:
    the outputs, the compressed rows (post-norm c_kv, rope'd k_pe) at
    1e-5 and `pos`; the caches' keys, shapes and dtypes equal."""
    jcfg, tcfg, pj, pt = _mla(32)
    x = _x(7, (B, 12, 64))
    c_j = JA.mla_init_cache(jcfg, B, 16)
    c_t = TA.mla_init_cache(tcfg, B, 16)
    assert _cache_layout(c_t) == _cache_layout(c_j)
    y_j, c_j = JA.mla_prefill(pj, jcfg, jnp.asarray(x[:, :9]), c_j)
    y_t, c_t = TA.mla_prefill(pt, tcfg, torch.from_numpy(x[:, :9]), c_t)
    _close(y_t, y_j)
    for t in range(9, 12):
        step = x[:, t:t + 1]
        y_j, c_j = JA.mla_decode(pj, jcfg, jnp.asarray(step), c_j)
        y_t, c_t = TA.mla_decode(pt, tcfg, torch.from_numpy(step), c_t)
        _close(y_t, y_j)
        assert c_t["pos"] == int(c_j["pos"]) == t + 1
        assert _cache_layout(c_t) == _cache_layout(c_j)
        for k in ("c_kv", "k_pe"):
            _close(c_t[k], c_j[k])


def test_flash_plain_with_a_narrower_value_head_matches_reference():
    """q/k of 48 and v of 32 (the reduced MLA's pair), causal and within a
    window of 5, at the MLA scale 1/sqrt(48): `ops.flash_attention` on CPU
    tensors against the reference's `grouped_attention` and its mask."""
    rng = np.random.default_rng(8)
    q, k = (rng.standard_normal((B, 13, 4, 48)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, 13, 4, 32)).astype(np.float32)
    scale = 48 ** -0.5
    for window in (None, 5):
        want = JA.grouped_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            JA.causal_mask(13, 13, window=window), scale=scale)
        got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=True, window=window, scale=scale)
        assert tuple(got.shape) == (B, 13, 4, 32)
        _close(got, want)
        if window is None:      # the default scale is 1/sqrt(DQK)
            _close(ops.flash_attention(*map(torch.from_numpy, (q, k, v))),
                   want)


@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "deepseek_v2_236b"])
def test_lm_loss_matches_reference(arch):
    """The reduced model's mean next-token loss, through every block kind
    of the family (DeepSeek-V2: an MLA + dense SwiGLU layer, then MLA +
    MoE with a shared expert)."""
    cfg_j = jget_config(arch).reduced(vocab=97)
    cfg_t = get_config(arch).reduced(vocab=97)
    assert cfg_t.n_experts == cfg_j.n_experts == 4
    model_j = jbuild_model(cfg_j)
    params_j = model_j.init(jax.random.PRNGKey(0))
    params_t = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t)
    model_t = build_model(cfg_t)
    assert [(g.n_repeat, g.specs[0].mixer, g.specs[0].mlp)
            for g in model_t.groups] == \
        [(g.n_repeat, g.specs[0].mixer, g.specs[0].mlp)
         for g in model_j.groups]
    rng = np.random.default_rng(9)
    batch = {k: rng.integers(0, 97, (B, 10)) for k in ("tokens", "labels")}
    want = model_j.loss(params_j, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    got = model_t.loss(params_t, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    _close(got, want)
