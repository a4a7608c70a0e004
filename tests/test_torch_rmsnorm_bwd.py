"""rmsnorm's backward in the port, `ref.rmsnorm_bwd_ref` (the plain
version of the backward kernels in `kernels/csrc/rmsnorm.cu`), against
the JAX reference on the CPU.

The reference has no backward kernel: it differentiates
`repro.nn.layers.rmsnorm_apply` through plain `jnp`, so `jax.grad` of
`sum(rmsnorm_apply(x) * g)` is the oracle.  Inputs come from numpy with a
seed, at widths 64, 768 and a ragged 100, with leading dims (2, 3).
Tolerances, each with its reason:

* float32: rtol 1e-5, atol 1e-6 x the largest gradient (`check_grads`'
  limits in chip_smoke.py): the closed form and autograd sum the row and
  the rows in other orders;
* bf16: within one bf16 ulp of the float32 gradient of the same bf16
  inputs, plus that float32 allowance: the result is rounded once to
  bf16 from a float32 value that differs from jax's by float32 rounding.

`_RMSNormFn` is held with only one of x and `scale` requiring grad (its
backward launch asks for only that gradient and counts the kernels the
card launches for it); its launches replaced by the plain versions, as in
tests/test_torch_lm_train.py, since a CUDA kernel has no CPU mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import layers as JL
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as trn

WIDTHS = (64, 768, 100)
LEAD = (2, 3)
EPS = 1e-6
TYPES = {"float32": (torch.float32, jnp.float32),
         "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, d):
    """x, scale and the output gradient g as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(LEAD + (d,)).astype(np.float32)
    sc = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    g = rng.standard_normal(LEAD + (d,)).astype(np.float32)
    return x, sc, g


def _round(a, name):
    """numpy float32 -> the type's values, as float32 numpy."""
    return np.array(jnp.asarray(a, TYPES[name][1]).astype(jnp.float32))


def _jax_grads(x, sc, g, x_type, s_type):
    """jax.grad of sum(rmsnorm_apply(x) * g) in the given types, and the
    same in float32 on the same (rounded) values."""
    def loss(xx, ss, gg):
        y = JL.rmsnorm_apply({"scale": ss}, xx, eps=EPS)
        return jnp.sum(y.astype(jnp.float32) * gg.astype(jnp.float32))
    grad = jax.grad(loss, argnums=(0, 1))
    xt, st = TYPES[x_type][1], TYPES[s_type][1]
    gt = (jnp.asarray(x, xt), jnp.asarray(sc, st), jnp.asarray(g, xt))
    typed = grad(*gt)
    f32 = grad(*(a.astype(jnp.float32) for a in gt))
    return ([np.asarray(a.astype(jnp.float32)) for a in typed],
            [np.asarray(a) for a in f32])


def _ulp(a):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def _held(got, want32, typed):
    """got (float32 numpy) against the float32 gradient: rtol 1e-5 with
    atol 1e-6 x the largest, plus one bf16 ulp where `typed` is bf16."""
    tol = 1e-5 * np.abs(want32) + 1e-6 * np.abs(want32).max()
    if typed == "bfloat16":
        tol = tol + _ulp(want32)
    return bool((np.abs(got - want32) <= tol).all())


def _torch(a, name):
    return torch.from_numpy(a).to(TYPES[name][0])


@pytest.mark.parametrize("x_type,s_type", [
    ("float32", "float32"), ("float32", "bfloat16"),
    ("bfloat16", "bfloat16"), ("bfloat16", "float32")])
def test_rmsnorm_bwd_ref_matches_jax_grad(x_type, s_type):
    """dx in x's type and dscale in scale's type, against jax.grad through
    the reference's rmsnorm_apply at each width; jax's own typed
    gradients are held to the same float32 gradient by the same rule."""
    for seed, d in enumerate(WIDTHS):
        x, sc, g = _inputs(seed, d)
        x, g = _round(x, x_type), _round(g, x_type)
        sc = _round(sc, s_type)
        dx, ds = ref.rmsnorm_bwd_ref(_torch(x, x_type), _torch(sc, s_type),
                                     _torch(g, x_type), EPS)
        assert dx.dtype == TYPES[x_type][0] and dx.shape == x.shape
        assert ds.dtype == TYPES[s_type][0] and ds.shape == sc.shape
        typed, f32 = _jax_grads(x, sc, g, x_type, s_type)
        for got, jt, want, name in ((dx, typed[0], f32[0], x_type),
                                    (ds, typed[1], f32[1], s_type)):
            assert _held(got.float().numpy(), want, name), (d, name)
            assert _held(jt, want, name), (d, name)


@pytest.mark.parametrize("x_type", ["float32", "bfloat16"])
def test_rmsnorm_bwd_ref_matches_autograd_of_rmsnorm_ref(x_type):
    """The closed form against torch autograd through `ref.rmsnorm_ref`,
    the forward's plain version, with scale in both types."""
    for s_type in TYPES:
        for seed, d in enumerate(WIDTHS):
            x, sc, g = _inputs(10 + seed, d)
            xt = _torch(x, x_type).requires_grad_()
            st = _torch(sc, s_type).requires_grad_()
            gt = _torch(g, x_type)
            (ref.rmsnorm_ref(xt, st, eps=EPS).float()
             * gt.float()).sum().backward()
            dx, ds = ref.rmsnorm_bwd_ref(xt.detach(), st.detach(), gt, EPS)
            # autograd's typed gradient is one rounding of its float32 one:
            # compare both to the float32 closed form on the same values
            want = ref.rmsnorm_bwd_ref(xt.detach().float(),
                                       st.detach().float(), gt.float(), EPS)
            for got, auto, w, name in ((dx, xt.grad, want[0], x_type),
                                       (ds, st.grad, want[1], s_type)):
                assert got.dtype == auto.dtype
                assert _held(got.float().numpy(), w.numpy(), name)
                assert _held(auto.float().numpy(), w.numpy(), name)


def test_rmsnorm_function_honours_needs_input_grad(monkeypatch):
    """Only x, or only scale, requiring grad: the backward launch is asked
    for that gradient alone (1 kernel for dx, 2 for dscale on the card),
    the other input gets None, and the gradient is the plain version's
    bitwise."""
    calls = []

    def launch(x, s, eps):
        trn.launches["rmsnorm"] += 1
        return ref.rmsnorm_ref(x, s, eps=eps)

    def launch_bwd(x, s, g, eps, need_x, need_s):
        calls.append((need_x, need_s))
        trn.launches["rmsnorm_bwd"] += 1 + int(need_s)
        dx, ds = ref.rmsnorm_bwd_ref(x, s, g, eps)
        return dx if need_x else None, ds if need_s else None
    monkeypatch.setattr(trn, "_launch", launch)
    monkeypatch.setattr(trn, "_launch_bwd", launch_bwd)
    x, sc, g = (torch.from_numpy(a) for a in _inputs(7, 768))
    for need in ((True, False), (False, True)):
        calls.clear()
        xt = x.clone().requires_grad_(need[0])
        st = sc.clone().requires_grad_(need[1])
        before = dict(trn.launches)
        y = trn._RMSNormFn.apply(xt, st, EPS)
        (y * g).sum().backward()
        assert calls == [need]
        assert trn.launches == {
            "rmsnorm": before["rmsnorm"] + 1,
            "rmsnorm_bwd": before["rmsnorm_bwd"] + 1 + int(need[1])}
        dx, ds = ref.rmsnorm_bwd_ref(x, sc, g, EPS)
        assert (xt.grad is None) != need[0]
        assert (st.grad is None) != need[1]
        if need[0]:
            assert torch.equal(xt.grad, dx)
        else:
            assert torch.equal(st.grad, ds)
