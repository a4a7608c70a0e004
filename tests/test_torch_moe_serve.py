"""The port's MoE family served split, against the JAX reference.

Reduced Qwen3-30B-A3B (2 GQA + MoE layers, 4 experts top-2) and reduced
DeepSeek-V2 (an MLA + dense SwiGLU layer, then MLA + MoE with a shared
expert; q/k heads of 32 + 16, v of 32), d_model 128, vocab 97, fp32, the
reference's parameters from PRNGKey(0) bridged over, prompts from
PRNGKey(1):

* `ServeSession` for the dense, fake-q8 and physical-q8 wires at prompt 7
  (no expert overflows) and 24 (experts overflow their capacity at
  prefill, so slots drop): greedy tokens equal to the JAX session's,
  `WireRecord`s of a decode step and of the prefill equal record for
  record, bytes per token equal, the client's caches after prefill (and
  the server's over the dense wire) at 1e-5;
* the fused q8 entry: Qwen3's equal to the reference's token for token,
  DeepSeek-V2's refused (its server entry is MLA), in both packages;
* the full-width models on meta tensors: Qwen3 whole (30.5B parameters)
  and DeepSeek-V2 cut to 8 layers, the reference's parameter count and
  groups, the cut inside the MoE group, 153,992 and 107,528 wire bytes
  per generated token per row, and the prefill's records;
* `python -m repro_torch.launch.serve --arch ... --reduced` on the CPU.
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
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build_model
from repro_torch.nn import moe as TM
from repro_torch.nn.module import param_count
from repro_torch.serve import ServePlan, ServeSession

B, GEN = 2, 6
PROMPTS = (7, 24)              # no expert overflows; experts overflow
ARCHS = ("qwen3_moe_30b_a3b", "deepseek_v2_236b")
TOL = dict(rtol=1e-5, atol=1e-5)
WIRES = {"dense": "", "fake_q8": "quantize_int8",
         "physical_q8": "quantize_int8:physical"}


@pytest.fixture(scope="module")
def setups():
    out = {}
    for arch in ARCHS:
        cfg_j = jget_config(arch).reduced(vocab=97)
        params_j = jbuild_model(cfg_j).init(jax.random.PRNGKey(0))
        cfg_t = get_config(arch).reduced(vocab=97)
        params_t = bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, params_j), cfg_t)
        out[arch] = (cfg_j, params_j, cfg_t, params_t)
    prompts = {s: np.array(jax.random.randint(jax.random.PRNGKey(1), (B, s),
                                              0, 97))
               for s in PROMPTS}
    return out, prompts


def _sessions(setup, wire, s, fused=False):
    cfg_j, params_j, cfg_t, params_t = setup
    kw = dict(max_batch=B, max_len=s + GEN + 2, wire=wire, fused_entry=fused)
    return (JServeSession(JServePlan(arch=cfg_j, **kw), params_j),
            ServeSession(ServePlan(arch=cfg_t, **kw), params_t,
                         device="cpu"))


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
                assert np.shape(g_t[i][k]) == np.shape(g_j[i][k])
                if k == "pos":
                    np.testing.assert_array_equal(g_t[i][k], g_j[i][k])
                else:
                    np.testing.assert_allclose(g_t[i][k], g_j[i][k], **TOL)


@pytest.mark.parametrize("s", PROMPTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_split_session_matches_reference(setups, arch, s, monkeypatch):
    """Every wire: tokens, records and bytes per token equal to the JAX
    session's, caches after prefill at 1e-5.  At prompt 24 some expert
    overflows at prefill (the port's `drop_fraction` over that prefill's
    MoE layers is above 0); at 7 none does."""
    setup, prompts = setups[0][arch], setups[1][s]
    drops = []
    apply = TM.moe_apply

    def counted(params, cfg, x, return_aux=False):
        out, aux = apply(params, cfg, x, return_aux=True)
        if x.shape[1] > 1 and not x.is_meta:         # a prefill's
            drops.append(float(aux["drop_fraction"]))
        return (out, aux) if return_aux else out
    monkeypatch.setattr(TM, "moe_apply", counted)
    for wire in WIRES.values():
        js, ts = _sessions(setup, wire, s)
        want = np.asarray(js.generate(jnp.asarray(prompts), GEN))
        got = ts.generate(torch.from_numpy(prompts), GEN)
        assert got.tolist() == want.tolist()
        assert _records(ts.decode_cost(1)) == _jrecords(js.decode_cost(1))
        assert _records(ts.prefill_cost(B, s)) == \
            _jrecords(js.prefill_cost(B, s))
        assert ts.bytes_per_token() == js.bytes_per_token() == \
            (128 + 4 + 97 + 4 if wire else 4 * (128 + 97))
        js.prefill(jnp.asarray(prompts))
        ts.prefill(torch.from_numpy(prompts))
        _check_caches(ts._cc, js._cc)
        if not wire:
            _check_caches(ts._sc, js._sc)
    assert (max(drops) > 0) == (s == 24)


def test_fused_entry(setups):
    """Qwen3's server entry is GQA + MoE: the fused q8 entry reads the
    packed payload and generates the reference's fused tokens.  DeepSeek's
    is MLA: both packages refuse the fused entry."""
    s, prompts = 7, setups[1][7]
    js, ts = _sessions(setups[0]["qwen3_moe_30b_a3b"], WIRES["physical_q8"],
                       s, fused=True)
    assert ts._fused is not None and ts._fused["spec"].mlp == "moe"
    want = np.asarray(js.generate(jnp.asarray(prompts), GEN))
    assert ts.generate(torch.from_numpy(prompts), GEN).tolist() == \
        want.tolist()
    assert _records(ts.decode_cost(B)) == _jrecords(js.decode_cost(B))
    cfg_j, params_j, cfg_t, params_t = setups[0]["deepseek_v2_236b"]
    kw = dict(wire=WIRES["physical_q8"], fused_entry=True)
    for make in (lambda: JServeSession(JServePlan(arch=cfg_j, **kw),
                                       params_j),
                 lambda: ServeSession(ServePlan(arch=cfg_t, **kw), params_t,
                                      device="cpu")):
        with pytest.raises(ValueError, match="fused_entry"):
            make()


FULL = {"qwen3_moe_30b_a3b": (None, 153992),
        "deepseek_v2_236b": (8, 107528)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_on_meta(arch):
    """The full-width model on meta tensors (DeepSeek-V2 cut to 8 of its
    60 layers): the reference's parameter count and groups, cut 4 inside
    the MoE group, wire bytes per generated token per row (d_model + 4
    up, vocab + 4 down), and the prefill's records."""
    n_layers, per_tok = FULL[arch]
    cfg_t, cfg_j = get_config(arch), jget_config(arch)
    if n_layers:
        cfg_t = dataclasses.replace(cfg_t, n_layers=n_layers)
        cfg_j = dataclasses.replace(cfg_j, n_layers=n_layers)
    model = build_model(cfg_t)
    params = model.init(torch.Generator(), "meta")
    shapes = jax.eval_shape(jbuild_model(cfg_j).init, jax.random.PRNGKey(0))
    assert param_count(params) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))
    assert [(g.n_repeat, g.specs[0].mixer, g.specs[0].mlp)
            for g in model.groups] == (
        [(48, "attn", "moe")] if arch.startswith("qwen3")
        else [(1, "mla", "swiglu"), (7, "mla", "moe")])
    moe = params["groups"][-1][0]["0"]["mlp"]
    assert moe["router"]["w"].dtype == torch.float32
    assert moe["gate"].dtype == torch.bfloat16
    ts = ServeSession(ServePlan(arch=cfg_t, max_batch=4, max_len=161,
                                wire=WIRES["physical_q8"]), params,
                      device="meta")
    assert ts.cut == 4
    assert [len(g) for g in ts.server_params["groups"]] == (
        [44] if arch.startswith("qwen3") else [4])
    assert ts.bytes_per_token() == per_tok == \
        (cfg_t.d_model + 4) + (cfg_t.vocab + 4)
    assert _records(ts.prefill_cost(4, 128)) == [
        ("prefill_act", (4, 128, cfg_t.d_model), "bfloat16", "up",
         4 * 128 * (cfg_t.d_model + 4), True),
        ("prefill_logits", (4, 1, cfg_t.vocab), "bfloat16", "down",
         4 * (cfg_t.vocab + 4), True)]


def test_launcher_serves_reduced_moe():
    """The CLI's JSON line for each family at reduced size on the CPU;
    DeepSeek-V2 refuses `--fused-entry`."""
    for arch, fused in (("qwen3_moe_30b_a3b", True),
                        ("deepseek_v2_236b", False)):
        argv = ["--arch", arch, "--reduced", "--split", "--wire",
                "quantize_int8:physical", "--device", "cpu", "--batch", "2",
                "--prompt-len", "9", "--gen", "4"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tlaunch.main(argv + (["--fused-entry"] if fused else []))
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        assert out["arch"] == get_config(arch).name
        assert out["device"] == "cpu" and out["fused_entry"] is fused
        assert out["wire_bytes_per_token"] == (128 + 4) + (256 + 4)
        assert len(out["sample_tokens"]) == 4
    with pytest.raises(SystemExit, match="fused_entry"):
        tlaunch.main(argv + ["--fused-entry"])
