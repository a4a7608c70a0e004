"""The port's sharded serving paths and its int8 KV cache, against the JAX
reference, on the CPU (the counterparts of `tests/test_perf_paths.py`).

* Expert-parallel MoE (`moe_apply_ep`, `MoEConfig.ep_axis`): at one rank
  (a `make_mesh_compat((1, 1), ("data", "model"))` mesh in this process)
  the output and every gradient BITWISE the port's `moe_apply`; at two and
  four gloo ranks (`tests/_torch_mesh_ranks.py`, one spawn per rank count,
  started when the module's first test runs) over 4 and 8 experts, with 0
  and 1 shared experts and capacity factors 1.25 (slots drop) and 8.0:
  the output, the gradient of x, the router's and the shared experts'
  and each expert weight's (all-gathered over the expert axis) within
  1e-6 of the tensor's largest magnitude of the port's single-device
  `moe_apply` and autograd, and within 2e-6 of it of the reference's
  `moe_apply` and `jax.grad`: a gradient sums T*k products in another
  order in each framework, and the single-device port's router gradient
  is already 1.13e-6 of its largest value from the reference's (its
  other tensors up to 7.3e-7); on a
  (2, 2) data x model mesh each data shard's rows held to the reference
  over those rows alone (the capacity is sized from the local rows, so
  under drops the whole batch is not the yardstick).
* Split-KV decode (`gqa_decode_sharded`, `AttnConfig.decode_kv_shard`)
  at one, two and four ranks, with and without the qkv bias, window None
  (a 12-row ring) and 8: 16 steps that cross the ring's wrap within 1e-5
  of the reference's base `gqa_decode` (its own sharded decode is not
  called: one case of it takes minutes here), and the chunks gathered
  over the ranks within 1e-5 of the reference's cache.
* The four refusals: a per-row `pos`, `qkv=`, an int8 cache and MLA under
  `decode_kv_shard` (and a ring the ranks do not divide).
* The int8 KV cache: `_quant_kv` bitwise the reference's on the same
  rows; prefill and decode with one cursor, with per-row cursors and
  through the `qkv=` entry against the reference's int8 cache: the int8
  rows bitwise, the scales bitwise the reference's quantizer over the
  port's own rows (the frameworks' projections and rope differ in the
  last bit, so the two caches' scales may too), outputs within 1e-6; and
  within 5% of the native cache's largest output, the reference test's
  bound.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as JA
from repro.nn import moe as JM
from repro_torch import bridge
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.nn import attention as TA
from repro_torch.nn import dist as tdist
from repro_torch.nn import moe as TM
from repro_torch.nn.module import tree_leaves, tree_map

import _torch_fleet_ranks as fleet_ranks
import _torch_mesh_ranks as ranks
from _torch_threads import one_torch_thread

one_torch_thread()

EP_TOL = 1e-6      # D ranks against one device, of the largest magnitude
REF_TOL = 2e-6     # against the reference (see the module's docstring)
KV_TOL = 1e-5
WORLDS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """One spawn per rank count, started with the module's first test."""
    out = {}
    for w in WORLDS:
        d = str(tmp_path_factory.mktemp(f"mesh{w}"))
        out[w] = (ranks.start("perf", w, d), d)
    yield out
    for procs, _ in out.values():
        fleet_ranks.stop(procs)


@pytest.fixture(scope="module")
def results(spawned):
    return {w: fleet_ranks.collect(procs, d, timeout=240.0)
            for w, (procs, d) in spawned.items()}


@pytest.fixture(scope="module")
def mesh11():
    mesh = make_mesh_compat((1, 1), ("data", "model"), device="cpu")
    tdist.set_mesh(mesh)
    return mesh


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _jtree(params):
    return jax.tree_util.tree_map(jnp.asarray, bridge.tree_to_numpy(params))


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_moe(case, rows=None) -> dict:
    """The reference's moe_apply and its gradient of sum(y * c) (`jax.vjp`
    with cotangent c) over the case's x (its rows [rows[0], rows[1]) of a
    batch of 4, when given)."""
    batch = 4 if rows else ranks.MOE_B
    params, x, c = ranks.moe_case(case, batch)
    if rows:
        x, c = x[rows[0]:rows[1]], c[rows[0]:rows[1]]
    e, sh, cf = case
    cfg = JM.MoEConfig(d_model=ranks.MOE_D, d_ff=ranks.MOE_F, n_experts=e,
                       top_k=2, n_shared=sh, capacity_factor=cf)

    @jax.jit
    def run(p, xx):
        y, vjp = jax.vjp(lambda p_, x_: JM.moe_apply(p_, cfg, x_), p, xx)
        return y, vjp(jnp.asarray(c))
    y, (gp, gx) = run(_jtree(params), jnp.asarray(x))
    return {"y": np.asarray(y), "dx": np.asarray(gx),
            "grads": jax.tree_util.tree_map(np.asarray, gp)}


def _near(got, want, tol: float, what: str):
    """Within `tol` of the tensor's largest magnitude (see the module's
    docstring)."""
    want = _np(want)
    err = np.abs(_np(got) - want).max()
    assert err <= tol * np.abs(want).max(), (what, err)


def _hold_moe(got: dict, want: dict, tol: float):
    g = want["grads"]
    _near(got["y"], want["y"], tol, "y")
    _near(got["dx"], want["dx"], tol, "dx")
    _near(got["router"], g["router"]["w"], tol, "router")
    for n in ("gate", "up", "down"):
        _near(got["experts"][n], g[n], tol, n)
    if got["shared"] is not None:
        for n, t in got["shared"].items():
            _near(t, g["shared"][n]["w"], tol, f"shared {n}")
    assert got["foreign_zero"]


@functools.lru_cache(maxsize=None)
def _port_moe(case, rows=None) -> dict:
    """The port's single-device moe_apply and autograd, as `_ref_moe`."""
    params, x, c = ranks.moe_case(case, 4 if rows else ranks.MOE_B)
    if rows:
        x, c = x[rows[0]:rows[1]], c[rows[0]:rows[1]]
    p = tree_map(lambda t: t.clone().requires_grad_(), params)
    xt = torch.from_numpy(x).requires_grad_()
    y = TM.moe_apply(p, ranks.moe_config(case), xt)
    (y * torch.from_numpy(c)).sum().backward()
    return {"y": y.detach(), "dx": xt.grad,
            "grads": tree_map(lambda t: t.grad, p)}


def _hold_ranks_moe(got: dict, case, rows=None):
    """Within EP_TOL of the port's single device, REF_TOL of the
    reference."""
    _hold_moe(got, _port_moe(case, rows), EP_TOL)
    _hold_moe(got, _ref_moe(case, rows), REF_TOL)


def _grads(case, cfg, mesh=None):
    params, x, c = ranks.moe_case(case)
    p = tree_map(lambda t: t.clone().requires_grad_(), params)
    xt = torch.from_numpy(x).requires_grad_()
    y = TM.moe_apply(p, cfg, xt)
    (y * torch.from_numpy(c)).sum().backward()
    return [y, xt.grad] + [t.grad for t in tree_leaves(p)]


@pytest.mark.parametrize("case", ranks.MOE_CASES, ids=str)
def test_moe_ep_one_rank_bitwise(mesh11, case):
    """D=1: output and every gradient bitwise the single-device path; the
    forward's one all_reduce and the backward's two (x and the router's
    weight) counted.  Slots drop at capacity factor 1.25, none at 8."""
    params, x, _ = ranks.moe_case(case)
    _, aux = TM.moe_apply(params, ranks.moe_config(case), torch.from_numpy(x),
                          return_aux=True)
    assert (float(aux["drop_fraction"]) > 0) == (case[2] == 1.25)
    mesh11.counts.clear()
    base = _grads(case, ranks.moe_config(case))
    ep = _grads(case, ranks.moe_config(case, ep_axis="model"))
    assert dict(mesh11.counts) == {"all_reduce": 3}
    for a, b in zip(base, ep):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world", WORLDS)
def test_moe_ep_ranks_match_reference(results, world):
    """D=2 and 4: every rank's output and gradients against the
    reference's, drops included, for every case."""
    for res in results[world]:
        for case in ranks.MOE_CASES:
            _hold_ranks_moe(res["moe"][case], case)


def test_moe_ep_data_by_model_mesh(results):
    """A (2, 2) mesh, the batch of 4 split over "data": each rank's rows
    against the reference over its data shard's rows alone."""
    seen = set()
    for res in results[4]:
        dm = res["dm"]
        d = dm["data"]
        seen.add((d, dm["model"]))
        _hold_ranks_moe(dm, ranks.DM_CASE, (2 * d, 2 * d + 2))
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}
    # slots drop in both shards, and otherwise than in the whole batch
    params, x, _ = ranks.moe_case(ranks.DM_CASE, 4)
    for rows in (slice(0, 2), slice(2, 4)):
        assert float(TM.moe_apply(
            params, ranks.moe_config(ranks.DM_CASE),
            torch.from_numpy(x[rows]), return_aux=True)[1]["drop_fraction"]) \
            > 0
    whole = _ref_moe(ranks.DM_CASE, (0, 4))["y"]
    got = np.concatenate([results[4][0]["dm"]["y"], results[4][2]["dm"]["y"]])
    assert np.abs(got - whole).max() > REF_TOL * np.abs(whole).max()


def test_moe_ep_expert_count_must_divide(mesh11):
    mesh = dataclasses.replace(mesh11, shape={"data": 1, "model": 3})
    tdist.set_mesh(mesh)
    try:
        cfg = ranks.moe_config((4, 0, 8.0), ep_axis="model")
        params, x, _ = ranks.moe_case((4, 0, 8.0))
        with pytest.raises(ValueError, match="do not divide"):
            TM.moe_apply(params, cfg, torch.from_numpy(x))
    finally:
        tdist.set_mesh(mesh11)


# ---------------------------------------------------------------------------
# split-KV decode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_kv(case):
    """The reference's base gqa_decode over the case's 16 steps: outputs
    and the final cache."""
    params, xs = ranks.kv_case(case)
    bias, window, max_len = case
    cfg = JA.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                        qkv_bias=bias, window=window)
    pj = _jtree(params)
    cache = JA.gqa_init_cache(cfg, 2, max_len)
    ys = []
    for x in xs:
        y, cache = JA.gqa_decode(pj, cfg, jnp.asarray(x), cache)
        ys.append(np.asarray(y))
    return np.stack(ys), jax.tree_util.tree_map(np.asarray, cache)


def _hold_kv(got: dict, case, world: int):
    ys, cache = _ref_kv(case)
    err = np.abs(_np(got["ys"]) - ys).max()
    assert err < KV_TOL, err
    ring = cache["k"].shape[1]
    assert got["chunk"] == (2, ring // world, 2, 8)
    assert got["pos"] == ranks.KV_STEPS == int(cache["pos"])
    assert ranks.KV_STEPS > ring                      # the ring wrapped
    for n in ("k", "v"):
        assert np.abs(_np(got[n]) - cache[n]).max() < KV_TOL


@pytest.mark.parametrize("case", ranks.KV_CASES, ids=str)
def test_split_kv_one_rank(mesh11, case):
    mesh11.counts.clear()
    got = ranks.run_kv(case, mesh11)
    _hold_kv(got, case, 1)
    # a step: the q|k|v gather, then max, (l, o) and the output all_reduce
    # (the test's two gathers of the ring after the last step)
    assert dict(mesh11.counts) == {"all_gather": ranks.KV_STEPS + 2,
                                   "all_reduce": 3 * ranks.KV_STEPS}


@pytest.mark.parametrize("world", WORLDS)
def test_split_kv_ranks_match_reference(results, world):
    for res in results[world]:
        for case in ranks.KV_CASES:
            _hold_kv(res["kv"][case], case, world)
        # every collective of a rank went through its counts
        steps = len(ranks.KV_CASES) * ranks.KV_STEPS
        moe = len(ranks.MOE_CASES)
        assert res["counts"] == {"all_reduce": 3 * moe + 3 * steps,
                                 "all_gather": 3 * moe + steps
                                 + 2 * len(ranks.KV_CASES)}


def test_split_kv_refusals(mesh11):
    """What the reference's sharded path cannot do is refused, with a
    message: a per-row pos, qkv=, an int8 cache, MLA; and a ring that
    does not divide over the ranks."""
    case = ranks.KV_CASES[0]
    params, xs = ranks.kv_case(case)
    cfg = ranks.attn_config(case, decode_kv_shard="model")
    x = torch.from_numpy(xs[0])
    cache = TA.gqa_init_cache(cfg, 2, 12)
    cache["pos"] = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="per-row"):
        TA.gqa_decode(params, cfg, x, cache)
    cache = TA.gqa_init_cache(cfg, 2, 12)
    qkv = (torch.zeros(2, 1, 32), torch.zeros(2, 1, 16),
           torch.zeros(2, 1, 16))
    with pytest.raises(ValueError, match="qkv="):
        TA.gqa_decode(params, cfg, x, cache, qkv=qkv)
    with pytest.raises(ValueError, match="int8"):
        ranks.attn_config(case, decode_kv_shard="model",
                          kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="GQA only"):
        TA.AttnConfig(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8,
                      kind="mla", decode_kv_shard="model")
    tdist.set_mesh(dataclasses.replace(mesh11, shape={"data": 1,
                                                      "model": 5}))
    try:
        with pytest.raises(ValueError, match="does not divide"):
            TA.gqa_init_cache(cfg, 2, 12)
    finally:
        tdist.set_mesh(mesh11)


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------

ATTN_KW = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8)


def _int8_pair(seed=0, **kw):
    jc = JA.AttnConfig(kv_cache_dtype="int8", **ATTN_KW, **kw)
    tc = TA.AttnConfig(kv_cache_dtype="int8", **ATTN_KW, **kw)
    pj = JA.gqa_init(jax.random.PRNGKey(seed), jc)
    pt = bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, pj))
    return jc, tc, pj, pt


def test_quant_kv_bitwise():
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((2, 9, 2, 8)).astype(np.float32) \
        * np.float32(10.0) ** rng.integers(-3, 3, (2, 9, 2, 1))
    rows[0, 0] = 0.0                              # the 1e-12 floor
    rows[1, 1, 0, :2] = [127.5, -127.0]           # halves round to even
    qj, sj = JA._quant_kv(jnp.asarray(rows))
    qt, st = TA._quant_kv(torch.from_numpy(rows))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        TA._dequant_kv(qt, st, torch.float32).numpy(),
        np.asarray(JA._dequant_kv(qj, sj, jnp.float32)))


def _hold_int8(ct, cj, y_t, y_j):
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), rtol=1e-6,
                               atol=1e-6)
    for n in ("k", "v"):
        np.testing.assert_array_equal(_np(ct[n]), np.asarray(cj[n]))
        np.testing.assert_allclose(_np(ct[n + "_scale"]),
                                   np.asarray(cj[n + "_scale"]), rtol=1e-6)


def _rows_quantized(ct, rows: dict, slot):
    """The cache's int8 rows and scales at ring `slot` (one int or (B,))
    bitwise the reference's quantizer over the rows written there."""
    b = torch.arange(2)
    for n, t in rows.items():
        qj, sj = JA._quant_kv(jnp.asarray(_np(t)))
        got_q = ct[n][b, slot] if isinstance(slot, torch.Tensor) \
            else ct[n][:, slot]
        got_s = ct[n + "_scale"][b, slot] \
            if isinstance(slot, torch.Tensor) else ct[n + "_scale"][:, slot]
        np.testing.assert_array_equal(_np(got_q), np.asarray(qj)[:, 0])
        np.testing.assert_array_equal(_np(got_s), np.asarray(sj)[:, 0])


@pytest.mark.parametrize("cursor", ["scalar", "per_row"])
def test_int8_cache_prefill_and_decode_match_reference(cursor):
    """Prefill 6 rows into a 10-row ring, then 8 decode steps (the ring
    wraps), one cursor or per-row cursors 6 and 4."""
    jc, tc, pj, pt = _int8_pair()
    rng = np.random.default_rng(5)
    cj, ct = JA.gqa_init_cache(jc, 2, 10), TA.gqa_init_cache(tc, 2, 10)
    assert ct["k"].dtype == torch.int8 and ct["k_scale"].shape == (2, 10, 2,
                                                                   1)
    xs = rng.standard_normal((2, 6, 32)).astype(np.float32)
    y_j, cj = JA.gqa_prefill(pj, jc, jnp.asarray(xs), cj)
    y_t, ct = TA.gqa_prefill(pt, tc, torch.from_numpy(xs), ct)
    _hold_int8(ct, cj, y_t, y_j)
    if cursor == "per_row":
        cj["pos"] = jnp.asarray([6, 4], jnp.int32)
        ct["pos"] = torch.tensor([6, 4], dtype=torch.int32)
    for _ in range(8):
        x = rng.standard_normal((2, 1, 32)).astype(np.float32)
        y_j, cj = JA.gqa_decode(pj, jc, jnp.asarray(x), cj)
        y_t, ct = TA.gqa_decode(pt, tc, torch.from_numpy(x), ct)
        _hold_int8(ct, cj, y_t, y_j)
    np.testing.assert_array_equal(_np(ct["pos"]), np.asarray(cj["pos"]))


def test_int8_cache_qkv_entry_matches_reference():
    """The fused entry's qkv=: the same flat q/k/v into both packages; v
    is written unroped, so its scales are bitwise the reference's cache's,
    and every row bitwise the reference's quantizer over the port's
    rope'd k."""
    jc, tc, pj, pt = _int8_pair(seed=1)
    rng = np.random.default_rng(6)
    cj, ct = JA.gqa_init_cache(jc, 2, 8), TA.gqa_init_cache(tc, 2, 8)
    for t in range(10):
        x = rng.standard_normal((2, 1, 32)).astype(np.float32)
        q, k, v = (rng.standard_normal((2, 1, w)).astype(np.float32)
                   for w in (32, 16, 16))
        y_j, cj = JA.gqa_decode(pj, jc, jnp.asarray(x), cj,
                                qkv=tuple(map(jnp.asarray, (q, k, v))))
        y_t, ct = TA.gqa_decode(pt, tc, torch.from_numpy(x), ct,
                                qkv=tuple(map(torch.from_numpy, (q, k, v))))
        _hold_int8(ct, cj, y_t, y_j)
        np.testing.assert_array_equal(_np(ct["v_scale"]),
                                      np.asarray(cj["v_scale"]))
        kr = TA.apply_rope(torch.from_numpy(k).reshape(2, 1, 2, 8),
                           torch.full((2, 1), t), theta=tc.rope_theta)
        _rows_quantized(ct, {"k": kr, "v": torch.from_numpy(v).reshape(
            2, 1, 2, 8)}, t % 8)


def test_int8_cache_close_to_native():
    """The reference test's check: 12 decode steps within 5% of the native
    cache's largest output; the cache 1 byte an element plus 4 a (slot,
    head)."""
    jc, tc, pj, pt = _int8_pair(seed=7)
    native = dataclasses.replace(tc, kv_cache_dtype="native")
    ca, cb = TA.gqa_init_cache(native, 2, 16), TA.gqa_init_cache(tc, 2, 16)
    nbytes = sum(t.numel() * t.element_size() for t in cb.values()
                 if isinstance(t, torch.Tensor))
    assert nbytes == 2 * 2 * 16 * 2 * (8 + 4)
    rng = np.random.default_rng(7)
    errs, mags = [], []
    for _ in range(12):
        x = torch.from_numpy(rng.standard_normal((2, 1, 32)).astype(
            np.float32))
        ya, ca = TA.gqa_decode(pt, native, x, ca)
        yb, cb = TA.gqa_decode(pt, tc, x, cb)
        errs.append(float((ya - yb).abs().max()))
        mags.append(float(ya.abs().max()))
    assert max(errs) < 0.05 * max(mags), (max(errs), max(mags))


def test_dist_helpers_on_meta_and_batch_axes(mesh11):
    """On meta tensors the collectives return the shapes they would and
    count nothing; `batch_axes` names the mesh's batch axes."""
    mesh11.counts.clear()
    x = torch.empty(2, 3, device="meta")
    assert tdist.all_gather(x, "model", -1).shape == (2, 3)
    assert tdist.reduce_from(x, "model").shape == (2, 3)
    assert tdist.all_reduce(x, "model", "max").device.type == "meta"
    assert not mesh11.counts
    assert tdist.batch_axes(mesh11) == ("data",)
    with pytest.raises(ValueError, match="no 'expert'"):
        tdist.all_reduce(torch.zeros(2), "expert")
