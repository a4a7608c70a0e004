"""The port's LM training forward and its gradients against the JAX
reference, on the CPU.

Reduced phi4-mini (dense GQA), Mamba2 (SSM, a sequence of two chunks)
and RecurrentGemma (hybrid: two (rglru, rglru, attn) super-blocks with a
window of 8, at a sequence past it), vocab 64, fp32 with TF32 off; the
reference's parameters from a PRNGKey bridged over, tokens and
cotangents drawn with numpy from a seed.  Each comparison differentiates
`sum(out * cotangent)` in both packages (`jax.grad` against
`torch.autograd`), so the whole vector-Jacobian product is held.
Tolerances, each with its reason:

* values (attention, blocks, logits, activations, losses): rtol = atol
  = 1e-5, the matmuls and the scans summing in other orders;
* gradients: rtol = 1e-4, atol = 1e-5 relative to the leaf's largest
  gradient (`_close_grads`): a backward sums over the batch and the
  sequence, so a leaf's gradient is a long sum whose rounding grows with
  it, and entries far below the leaf's scale carry that absolute error;
* the doubling scan against the old in-place one, and the kernels'
  autograd plumbing on the CPU: BITWISE (the same arithmetic); rmsnorm's
  backward, a closed form of its own, BITWISE to its plain version
  `ref.rmsnorm_bwd_ref` and within rtol 1e-5 (atol 1e-6 x the largest)
  of autograd through the plain forward, which sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import synthetic as jsyn
from repro.models import build_model as jbuild_model
from repro.nn import attention as JA
from repro.nn import rglru as JR
from repro.nn import transformer as JT
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.data import synthetic as syn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.models import build_model
from repro_torch.nn import attention as TA
from repro_torch.nn import module as tmod
from repro_torch.nn import rglru as R
from repro_torch.nn import transformer as TT
from _torch_threads import one_torch_thread

one_torch_thread()

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
B = 2
FAMILIES = {
    # arch: (reduced overrides, sequence, cut)
    "phi4_mini_3_8b": (dict(vocab=64), 12, 1),
    "mamba2_130m": (dict(vocab=64), 16, 1),              # chunk 8: 2 chunks
    "recurrentgemma_2b": (dict(vocab=64, n_layers=6, window=8), 20, 3),
}


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _close_grads(t_leaves, j_leaves):
    """Leafwise: |got - want| <= GRAD_RTOL |want| + GRAD_ATOL x the leaf's
    largest gradient."""
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _tleaves(tree):
    """The port's leaves of a dict tree in the reference's order."""
    return _leaves(bridge.tree_to_numpy(tree))


def _tgrad(fn, *trees):
    """(fn(*trees), grads of fn's scalar w.r.t. every tree) in torch."""
    leaves = [tmod.tree_map(lambda t: t.detach().clone().requires_grad_(),
                            tr) for tr in trees]
    out = fn(*leaves)
    out.backward()
    return out.detach(), [tmod.tree_map(
        lambda t: torch.zeros_like(t) if t.grad is None else t.grad, tr)
        for tr in leaves]


def _jgrad(fn, *trees):
    """(fn(*trees), its grads) in JAX, compiled: eager JAX dispatches op
    by op and takes several times longer here."""
    return jax.jit(jax.value_and_grad(
        fn, argnums=tuple(range(len(trees)))))(*trees)


def _vjp_pair(j_apply, t_apply, pj, pt, x, seed):
    """Both packages' outputs and the gradients of sum(out * ct) with
    respect to (params, x)."""
    out_j = j_apply(pj, jnp.asarray(x))
    ct = np.random.default_rng(seed).standard_normal(
        out_j.shape).astype(np.float32)
    (_, (gp_j, gx_j)) = _jgrad(
        lambda p, xx: (j_apply(p, xx) * ct).sum(), pj, jnp.asarray(x))
    out_t = t_apply(pt, torch.from_numpy(x))
    _, (gp_t, gx_t) = _tgrad(
        lambda p, xx: (t_apply(p, xx) * torch.from_numpy(ct)).sum(), pt,
        torch.from_numpy(x))
    return out_t, out_j, (gp_t, gx_t), (gp_j, gx_j)


def _check_vjp(j_apply, t_apply, pj, pt, x, seed):
    out_t, out_j, (gp_t, gx_t), (gp_j, gx_j) = _vjp_pair(
        j_apply, t_apply, pj, pt, x, seed)
    _close(out_t, out_j)
    _close_grads([gx_t] + _tleaves(gp_t), [gx_j] + _leaves(gp_j))


def _bridged(pj):
    return bridge.tree_from_jax(jax.tree_util.tree_map(np.asarray, pj))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_gqa_apply_values_and_grads_match_reference():
    """Causal and within a 5-row window (through `ops.flash_attention`),
    values and gradients; and an explicit (B, S, T) mask, which takes the
    plain grouped attention, values."""
    for window in (None, 5):
        kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                  rope_fraction=0.75, window=window)
        jcfg, tcfg = JA.AttnConfig(**kw), TA.AttnConfig(**kw)
        pj = JA.gqa_init(jax.random.PRNGKey(11), jcfg)
        x = np.random.default_rng(12).standard_normal((B, 13, 64)).astype(
            np.float32)
        _check_vjp(lambda p, xx: JA.gqa_apply(p, jcfg, xx),
                   lambda p, xx: TA.gqa_apply(p, tcfg, xx), pj, _bridged(pj),
                   x, 13)
    kw = dict(d_model=32, n_heads=2, n_kv_heads=1, head_dim=16)
    jcfg, tcfg = JA.AttnConfig(**kw), TA.AttnConfig(**kw)
    pj = JA.gqa_init(jax.random.PRNGKey(14), jcfg)
    rng = np.random.default_rng(15)
    x = rng.standard_normal((B, 6, 32)).astype(np.float32)
    mask = rng.random((B, 6, 6)) < 0.7
    mask[:, np.arange(6), np.arange(6)] = True        # no empty row
    want = JA.gqa_apply(pj, jcfg, jnp.asarray(x), mask=jnp.asarray(mask))
    got = TA.gqa_apply(_bridged(pj), tcfg, torch.from_numpy(x),
                       mask=torch.from_numpy(mask))
    _close(got, want)


def test_rglru_block_and_scan_match_reference():
    """`rglru_block_apply`'s values and gradients; `rglru_scan`'s
    gradients at lengths that are and are not powers of 2, and its
    forward bitwise to the old in-place scan."""
    kw = dict(d_model=32, lru_width=24)
    jcfg, tcfg = JR.RGLRUConfig(**kw), R.RGLRUConfig(**kw)
    pj = JR.rglru_init(jax.random.PRNGKey(16), jcfg)
    rng = np.random.default_rng(17)
    # the reference inits the gate biases to 0: move them off it
    for k in ("gate_a", "gate_x"):
        pj[k]["b"] = jnp.asarray(0.5 * rng.standard_normal(24), jnp.float32)
    x = rng.standard_normal((B, 11, 32)).astype(np.float32)
    _check_vjp(lambda p, xx: JR.rglru_block_apply(p, jcfg, xx),
               lambda p, xx: R.rglru_block_apply(p, tcfg, xx), pj,
               _bridged(pj), x, 18)
    for s in (1, 2, 13, 64, 300):
        _check_scan(s)


def _old_inplace_scan(a, u):
    """The doubling scan as serving ran it before it was made out of
    place: the bitwise oracle for the new one's forward."""
    h, a = u.clone(), a.clone()
    S, step = a.shape[1], 1
    while step < S:
        carry = h[:, :-step] * a[:, step:]
        if 2 * step < S:
            a[:, step:] = a[:, :-step] * a[:, step:]
        h[:, step:] += carry
        step *= 2
    return h


def _check_scan(s):
    rng = np.random.default_rng(19)
    a = rng.uniform(0.5, 1.0, (B, s, 8)).astype(np.float32)
    u = rng.standard_normal((B, s, 8)).astype(np.float32)
    ct = rng.standard_normal((B, s, 8)).astype(np.float32)
    at, ut = torch.from_numpy(a), torch.from_numpy(u)
    assert torch.equal(R.rglru_scan(at, ut), _old_inplace_scan(at, ut))
    _, (ga_j, gu_j) = _jgrad(lambda aa, uu: (JR.rglru_scan(aa, uu)
                                             * ct).sum(), jnp.asarray(a),
                             jnp.asarray(u))
    _, (ga_t, gu_t) = _tgrad(lambda aa, uu: (R.rglru_scan(aa, uu)
                                             * torch.from_numpy(ct)).sum(),
                             at, ut)
    _close_grads([ga_t, gu_t], [ga_j, gu_j])


# ---------------------------------------------------------------------------
# blocks and the LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    arch = request.param
    red, seq, cut = FAMILIES[arch]
    cj, ct = jget_config(arch).reduced(**red), get_config(arch).reduced(**red)
    mj, mt = jbuild_model(cj), build_model(ct)
    pj = mj.init(jax.random.PRNGKey(20))
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj), ct)
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cj.vocab, (B, seq + 1))
    mask = (rng.random((B, seq)) < 0.7).astype(np.float32)
    bj = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "labels": jnp.asarray(toks[:, 1:], jnp.int32),
          "loss_mask": jnp.asarray(mask)}
    bt = {"tokens": torch.from_numpy(toks[:, :-1]),
          "labels": torch.from_numpy(toks[:, 1:]),
          "loss_mask": torch.from_numpy(mask)}
    return arch, cut, mj, mt, pj, pt, bj, bt


def _block_cases():
    out = []
    for arch, (red, _, _) in FAMILIES.items():
        cj = jget_config(arch).reduced(**red)
        for i, spec in enumerate(jbuild_model(cj).groups[0].specs):
            out.append((arch, i, f"{arch}-{spec.mixer}-{spec.mlp}-{i}"))
    return out


BLOCKS = _block_cases()


def test_block_apply_values_and_grads_match_reference():
    """Every block kind the three families build: attn + swiglu (phi4),
    mamba2 (no channel mixer), rglru + gelu and windowed attn + gelu
    (RecurrentGemma)."""
    for arch, i, _ in BLOCKS:
        _check_block(arch, i)


def _check_block(arch, i):
    red, seq, _ = FAMILIES[arch]
    cj, ct = jget_config(arch).reduced(**red), get_config(arch).reduced(**red)
    jspec = jbuild_model(cj).groups[0].specs[i]
    tspec = build_model(ct).groups[0].specs[i]
    assert (tspec.mixer, tspec.mlp) == (jspec.mixer, jspec.mlp)
    pj = JT.block_init(jax.random.PRNGKey(22 + i), jspec)
    x = np.random.default_rng(23).standard_normal(
        (B, seq, cj.d_model)).astype(np.float32)
    _check_vjp(lambda p, xx: JT.block_apply(p, jspec, xx),
               lambda p, xx: TT.block_apply(p, tspec, xx), pj, _bridged(pj),
               x, 24 + i)


def test_lm_forward_loss_and_split_halves_match_reference(family):
    """Logits, the masked and the unmasked loss, and the loss's gradient
    over the whole tree (tied embedding included); then the split
    halves."""
    _, _, mj, mt, pj, pt, bj, bt = family
    _close(mt.forward(pt, bt), mj.forward(pj, bj))
    unmasked = {k: v for k, v in bt.items() if k != "loss_mask"}
    _close(mt.loss(pt, unmasked),
           mj.loss(pj, {k: v for k, v in bj.items() if k != "loss_mask"}))
    lj, (gj,) = _jgrad(lambda p: mj.loss(p, bj), pj)
    lt, (gt,) = _tgrad(lambda p: mt.loss(p, bt), pt)
    _close(lt, lj)
    _close_grads(_leaves(bridge.params_to_numpy(gt)), _leaves(gj))
    _check_split_halves(family)


def _check_split_halves(family):
    """apply_client's activation and apply_server's logits, and the
    gradients of sum(logits * ct) through both halves."""
    _, cut, mj, mt, pj, pt, bj, bt = family
    pcj, psj = mj.split_params(pj, cut)
    pct, pst = mt.split_params(pt, cut)
    act_j = mj.apply_client(pcj, bj, cut)
    _close(mt.apply_client(pct, bt, cut), act_j)
    _close(mt.apply_server(pst, torch.from_numpy(np.array(act_j)), cut),
           mj.apply_server(psj, act_j, cut))
    ct = np.random.default_rng(25).standard_normal(
        mj.forward(pj, bj).shape).astype(np.float32)

    def j_obj(pc, ps):
        return (mj.apply_server(ps, mj.apply_client(pc, bj, cut), cut)
                * ct).sum()

    def t_obj(pc, ps):
        return (mt.apply_server(ps, mt.apply_client(pc, bt, cut), cut)
                * torch.from_numpy(ct)).sum()
    _, (gcj, gsj) = _jgrad(j_obj, pcj, psj)
    _, (gct, gst) = _tgrad(t_obj, pct, pst)
    _close_grads(_leaves(bridge.params_to_numpy(gct))
                 + _leaves(bridge.params_to_numpy(gst)),
                 _leaves(gcj) + _leaves(gsj))


# ---------------------------------------------------------------------------
# the kernels' autograd Functions and the data
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, carried):
    b, s, h, g, p, n = 2, 16, 4, 2, 8, 6
    proj = rng.standard_normal((b, s, h * p + 2 * g * n + 3)).astype(
        np.float32)
    xbc = torch.from_numpy(proj)[..., 3:]     # views with a projection stride
    x = xbc[..., :h * p].reshape(b, s, h, p)
    Bm = xbc[..., h * p:h * p + g * n].reshape(b, s, g, n)
    Cm = xbc[..., h * p + g * n:].reshape(b, s, g, n)
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal(
        (b, s, h)))).astype(np.float32))
    A = -torch.linspace(1.0, 4.0, h)
    init = (torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(
        np.float32)) if carried else None)
    return (x, dt, A, Bm, Cm, init)


CASES = ["rmsnorm", "flash", "flash_window", "ssd_zero", "ssd_carried"]


def test_kernel_functions_backpropagate_the_plain_gradient(monkeypatch):
    """Each kernel wrapper's autograd Function (rmsnorm, flash causal and
    windowed, the SSD from a zero and a carried state), with its launch
    replaced by the plain forward (a CUDA kernel has no CPU mode; on the
    card the wrapper routes a grad-requiring input here, which
    tests/test_torch_kernels.py holds): the output has a grad_fn and the
    forward counts one launch.  Flash's and the SSD's backward equals
    plain autograd bitwise and launches nothing; rmsnorm's goes through
    its backward launch once, asking for dx and dscale (2 kernels on the
    card), and gives its plain version `ref.rmsnorm_bwd_ref` bitwise."""
    for case in CASES:
        _check_function(case, monkeypatch)


def _check_function(case, monkeypatch):
    rng = np.random.default_rng(26)
    bwd_calls = []
    if case == "rmsnorm":
        mod = trn
        ins = (torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(
            np.float32)), torch.from_numpy(1 + 0.1 * rng.standard_normal(
                16).astype(np.float32)))
        extra = (1e-6,)

        def plain(x, s, eps):
            return ref.rmsnorm_ref(x, s, eps=eps)

        def launch_bwd(x, s, g, eps, need_x, need_s):
            """The backward kernels' plain version; counts what the card
            launches (the rows kernel, and the column sum for dscale)."""
            bwd_calls.append((need_x, need_s))
            mod.launches["rmsnorm_bwd"] += 1 + int(need_s)
            dx, ds = ref.rmsnorm_bwd_ref(x, s, g, eps)
            return dx if need_x else None, ds if need_s else None
        monkeypatch.setattr(mod, "_launch_bwd", launch_bwd)
        fn = trn._RMSNormFn
    elif case.startswith("flash"):
        mod = tfa
        ins = tuple(torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)) for shape in ((2, 7, 4, 16), (2, 7, 2, 16),
                                       (2, 7, 2, 16)))
        extra = (True, 3 if case == "flash_window" else None, 0.25)

        def plain(q, k, v, causal, window, scale):
            return ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window, scale=scale)
        fn = tfa._FlashFn
    else:
        mod = tssd
        ins = _ssd_inputs(rng, case == "ssd_carried")
        extra = (8, True)

        def plain(x, dt, A, Bm, Cm, init, chunk, return_state):
            return tssd.ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=chunk,
                                          initial_state=init,
                                          return_state=return_state)
        fn = tssd._SSDFn
    name = next(iter(mod.launches))          # the forward's counter

    def launch(*args):
        mod.launches[name] += 1
        return plain(*args)

    monkeypatch.setattr(mod, "_launch", launch)
    leaves_p = [None if t is None else t.detach().clone().requires_grad_()
                for t in ins]
    leaves_k = [None if t is None else t.detach().clone().requires_grad_()
                for t in ins]
    before = dict(mod.launches)
    fwd = {**before, name: before[name] + 1}
    out_k = fn.apply(*leaves_k, *extra)
    assert mod.launches == fwd
    out_p = plain(*leaves_p, *extra)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    assert all(o.grad_fn is not None for o in out_k)
    cts = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32))
           for o in out_p]
    sum((o * c).sum() for o, c in zip(out_k, cts)).backward()
    sum((o * c).sum() for o, c in zip(out_p, cts)).backward()
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    if case != "rmsnorm":
        assert mod.launches == fwd
        for a, b in zip(leaves_k, leaves_p):
            if a is not None:
                assert torch.equal(a.grad, b.grad)
        return
    assert bwd_calls == [(True, True)]
    assert mod.launches == {**fwd, "rmsnorm_bwd": before["rmsnorm_bwd"] + 2}
    want = ref.rmsnorm_bwd_ref(*ins, cts[0], extra[0])
    for a, w, b in zip(leaves_k, want, leaves_p):
        assert torch.equal(a.grad, w)
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5,
                                   atol=1e-6 * b.grad.abs().max().item())


def test_lm_batch_follows_the_reference_rule():
    """The noisy bigram rule, next = (5 cur + noise) % vocab with noise in
    [0, 7), labels the tokens shifted by one: held on the port's draw and
    on the reference's (whose bits the port cannot reproduce)."""
    vocab = 50
    bt = syn.lm_batch(torch.Generator().manual_seed(0), 3, 40, vocab)
    bj = jsyn.lm_batch(jax.random.PRNGKey(0), 3, 40, vocab)
    it = syn.lm_stream(torch.Generator().manual_seed(0), 3, 40, vocab)
    assert torch.equal(next(it)["tokens"], bt["tokens"])
    for b in (bt, {k: torch.from_numpy(np.array(v)) for k, v in
                   bj.items()}):
        tok, lab = b["tokens"].long(), b["labels"].long()
        assert tuple(tok.shape) == tuple(lab.shape) == (3, 40)
        assert torch.equal(lab[:, :-1], tok[:, 1:])
        noise = (lab - 5 * tok) % vocab
        assert int(noise.min()) >= 0 and int(noise.max()) < 7
        assert int(tok.min()) >= 0 and int(tok.max()) < vocab
    assert bt["tokens"].dtype == torch.int64
