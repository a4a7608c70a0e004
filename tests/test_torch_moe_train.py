"""MoE training in the port against the JAX reference, on the CPU: the
gradients through the capacity dispatch and through MLA, `LM.loss` of the
MoE family, split training through `Plan`, and split serving under
expert parallelism at two ranks.

* `moe_apply` (4 experts top-2, a shared expert) at capacity factors 0.5
  (slots drop) and 1.25, and `mla_apply` with and without the q LoRA:
  outputs and the gradients of sum(out * cotangent) with respect to the
  parameters and x, against `jax.grad`;
* `LM.loss` of reduced Qwen3-30B-A3B (GQA + MoE) and DeepSeek-V2 (an MLA
  + dense SwiGLU layer, then MLA + MoE with a shared expert), vocab 64:
  the loss and its gradient over the whole tree, against `jax.grad`;
* `Plan(mode="vanilla", model=lm_split_fns(model, 1))` over 2 clients of
  2 rows a turn, 3 rounds, the dense wire with the p2p handoff, SGD with
  momentum (0.02, 0.9; AdamW drifts the frameworks apart where its two
  moments nearly cancel, `tests/test_torch_lm_plan.py`), both packages
  from the reference's init: per-turn losses and the state after 3
  rounds, the meter's bytes and the wire report exactly;
* reduced Qwen3-MoE (vocab 97, prompt 24: experts overflow at prefill)
  served split through the fused entry over the physical wire with
  `ep_axis="model"` on both MoE layers, at two gloo ranks
  (`tests/_torch_mesh_ranks.py`, started when the module's first test
  runs): every rank's greedy tokens and bytes per token equal to the
  reference `ServeSession`'s.

Tolerances, as `tests/test_torch_lm_train.py` sets them: values rtol =
atol = 1e-5; gradients rtol 1e-4 with atol 1e-5 of the leaf's largest
gradient (a backward sums over the batch and the sequence in another
order in each framework).  fp32 with TF32 off.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.api import Plan as JPlan
from repro.api import lm_split_fns as jlm_split_fns
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.nn import attention as JA
from repro.nn import moe as JM
from repro.serve import ServePlan as JServePlan
from repro.serve import ServeSession as JServeSession
from repro_torch import bridge, optim
from repro_torch.api import Plan, lm_split_fns
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.nn import attention as TA
from repro_torch.nn import moe as TM

import _torch_fleet_ranks as fleet_ranks
import _torch_mesh_ranks as ranks
from _torch_threads import one_torch_thread
from test_torch_lm_train import (_bridged, _check_vjp, _close, _close_grads,
                                 _jgrad, _leaves, _tgrad)

one_torch_thread()

ARCHS = ("qwen3_moe_30b_a3b", "deepseek_v2_236b")
B, SEQ, N_CLIENTS, ROUNDS, CUT, LR = 2, 12, 2, 3, 1, 0.02
SERVE_WORLD = 2


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module", autouse=True)
def serve_ranks(tmp_path_factory):
    """The reference's reduced Qwen3-MoE parameters (bridged) and prompts
    saved for the ranks, the ranks started, and the reference's tokens."""
    out_dir = str(tmp_path_factory.mktemp("ep_serve"))
    cfg_j = jget_config(ranks.SERVE_ARCH).reduced(vocab=ranks.SERVE_VOCAB)
    params_j = jbuild_model(cfg_j).init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(3).integers(
        0, ranks.SERVE_VOCAB, (ranks.SERVE_B, ranks.SERVE_PROMPT))
    cfg_t = get_config(ranks.SERVE_ARCH).reduced(vocab=ranks.SERVE_VOCAB)
    torch.save({"params": bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params_j), cfg_t),
        "prompts": torch.from_numpy(prompts)},
        f"{out_dir}/serve_inputs.pt")
    procs = ranks.start("serve", SERVE_WORLD, out_dir)
    plan = JServePlan(arch=cfg_j, max_batch=ranks.SERVE_B,
                      max_len=ranks.SERVE_PROMPT + ranks.SERVE_GEN + 2,
                      wire="quantize_int8:physical", fused_entry=True)
    sess = JServeSession(plan, params_j)
    want = {"tokens": np.asarray(sess.generate(jnp.asarray(prompts),
                                               ranks.SERVE_GEN)),
            "bytes_per_token": sess.bytes_per_token()}
    yield procs, out_dir, want
    fleet_ranks.stop(procs)


# ---------------------------------------------------------------------------
# the layers' gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_apply_gradient_matches_reference(cf):
    kw = dict(d_model=32, d_ff=48, n_experts=4, top_k=2, n_shared=1,
              capacity_factor=cf)
    jcfg, tcfg = JM.MoEConfig(**kw), TM.MoEConfig(**kw)
    pj = JM.moe_init(jax.random.PRNGKey(11), jcfg)
    x = np.random.default_rng(12).standard_normal((B, 13, 32)).astype(
        np.float32)
    _, aux = TM.moe_apply(_bridged(pj), tcfg, torch.from_numpy(x),
                          return_aux=True)
    assert (float(aux["drop_fraction"]) > 0) == (cf == 0.5)
    _check_vjp(lambda p, xx: JM.moe_apply(p, jcfg, xx),
               lambda p, xx: TM.moe_apply(p, tcfg, xx), pj, _bridged(pj), x,
               13)


@pytest.mark.parametrize("q_lora_rank", [32, 0])
def test_mla_apply_gradient_matches_reference(q_lora_rank):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=24, kind="mla",
              kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
              v_head_dim=16, q_lora_rank=q_lora_rank)
    jcfg, tcfg = JA.AttnConfig(**kw), TA.AttnConfig(**kw)
    pj = JA.mla_init(jax.random.PRNGKey(14), jcfg)
    x = np.random.default_rng(15).standard_normal((B, 11, 64)).astype(
        np.float32)
    _check_vjp(lambda p, xx: JA.mla_apply(p, jcfg, xx),
               lambda p, xx: TA.mla_apply(p, tcfg, xx), pj, _bridged(pj), x,
               16)


def _models(arch):
    cj = jget_config(arch).reduced(vocab=64)
    ct = get_config(arch).reduced(vocab=64)
    return jbuild_model(cj), build_model(ct), ct


def _tokens(seed, lead):
    """{"tokens", "labels"} of `lead` + (SEQ,) in both packages by
    `data/synthetic.py:lm_batch`'s rule (next = (5 cur + noise) % 64)."""
    rng = np.random.default_rng(seed)
    toks = [rng.integers(0, 64, lead)]
    for n in rng.integers(0, 7, (SEQ,) + lead):
        toks.append((5 * toks[-1] + n) % 64)
    toks = np.stack(toks, axis=-1)
    return ({"tokens": jnp.asarray(toks[..., :-1], jnp.int32),
             "labels": jnp.asarray(toks[..., 1:], jnp.int32)},
            {"tokens": torch.from_numpy(toks[..., :-1]),
             "labels": torch.from_numpy(toks[..., 1:])})


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_gradient_matches_reference(arch):
    mj, mt, ct = _models(arch)
    pj = mj.init(jax.random.PRNGKey(0))
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), ct)
    bj, bt = _tokens(17, (B,))
    lj, (gj,) = _jgrad(lambda p: mj.loss(p, bj), pj)
    lt, (gt,) = _tgrad(lambda p: mt.loss(p, bt), pt)
    _close(lt, lj)
    _close_grads(_leaves(bridge.params_to_numpy(gt)), _leaves(gj))


# ---------------------------------------------------------------------------
# split training through Plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_vanilla_split_fit_matches_reference(arch):
    mj, mt, _ = _models(arch)
    common = dict(mode="vanilla", n_clients=N_CLIENTS, cut=CUT)
    jsess = JPlan(model=jlm_split_fns(mj, CUT),
                  optimizer=joptim.sgd(LR, 0.9), **common).compile()
    jsess.init(jax.random.PRNGKey(0))
    tsess = Plan(model=lm_split_fns(mt, CUT), optimizer=optim.sgd(LR, 0.9),
                 **common).compile(device="cpu")
    tsess.state = bridge.lm_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jsess.state))
    batches = [_tokens(100 + r, (N_CLIENTS, B)) for r in range(ROUNDS)]
    lj = [np.asarray(jsess.run_round(b[0])) for b in batches]
    lt = [tsess.run_round(b[1]).numpy() for b in batches]
    np.testing.assert_allclose(np.stack(lt), np.stack(lj), rtol=1e-5,
                               atol=1e-5)
    assert lt[-1].mean() < lt[0].mean()
    t_leaves = _leaves(bridge.lm_state_to_numpy(tsess.state))
    j_leaves = _leaves(jax.tree_util.tree_map(np.asarray, jsess.state))
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert tsess.meter()["client_gb"] == jsess.meter()["client_gb"]
    for name in ("bytes_up", "bytes_down", "sync_bytes"):
        assert getattr(tsess.engine.meter, name) == getattr(
            jsess.engine.meter, name)
    rep = tsess.wire_report(batches[0][1])
    assert rep == jsess.wire_report(batches[0][0])
    cut_bytes = B * SEQ * 4 * mt.cfg.d_model
    assert [r["bytes"] for r in rep] == [cut_bytes, cut_bytes]


# ---------------------------------------------------------------------------
# split serving under expert parallelism, two ranks
# ---------------------------------------------------------------------------

def test_ep_split_serving_two_ranks_matches_reference(serve_ranks):
    procs, out_dir, want = serve_ranks
    got = fleet_ranks.collect(procs, out_dir, timeout=240.0)
    assert len(got) == SERVE_WORLD
    for res in got:
        np.testing.assert_array_equal(res["serve"]["tokens"].numpy(),
                                      want["tokens"])
        assert res["serve"]["bytes_per_token"] == want["bytes_per_token"]
        # one all_reduce a MoE layer a forward: the prefill and 5 steps
        # over 2 layers (the probes on meta count nothing)
        assert res["counts"] == {"all_reduce": 2 * ranks.SERVE_GEN}
