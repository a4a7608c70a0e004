"""The port's wire kernels against the JAX reference.

On the CPU each wrapper in `repro_torch.kernels` takes its plain torch
version; these tests hold those against `repro.kernels.ref` AND against
the reference's Pallas kernels run in interpret mode, on the same numpy
inputs:

* wire quantize / dequantize and the fake quantizer: BITWISE, for fp32
  and bf16, ragged rows, rows of zeros, 0-d leaves, a ragged row that
  takes the kernel's cluster path, rows of exact halves (round half to
  even) and quotients one ulp either side of the halves;
  `wire_roundtrip`'s output and gradient BITWISE against `jax.vjp` of the
  reference's custom VJP;
* the fused q8 entry matmul: allclose at rtol=atol=1e-4 (the sums run in
  another order), for 1 and 2 parts, with and without a bias, at odd
  widths;
* the dense splitcat entry: on `tests/test_kernels.py`'s shapes (1, 2
  and 3 parts, ragged K, with and without a bias) allclose at 1e-5 in
  fp32 and at bf16's own tolerance in bf16, and `splitcat_linear_packed`
  over dense parts equal to the reference's;
* rmsnorm on `tests/test_kernels.py`'s shapes and its unpadded ragged
  rows: fp32 at 1e-6 (one float32 rounding apart), bf16 within one bf16
  ulp;
* the SSD scan on `tests/test_kernels.py`'s sweep: the plain chunked form
  against the reference's interpret-mode kernel and its O(S) oracle at
  1e-4 in fp32 and at the reference's 5e-2 in bf16 (the two round x*dt
  at different places), and the port's O(S) oracle against the
  reference's;
* flash attention's plain version on `tests/test_kernels.py`'s sweep
  (causal with GQA, windows 32/64/100, non-causal) against the
  reference's interpret-mode kernel and its oracle, at the reference's
  2e-5 in fp32 and 3e-2 in bf16; at head_dim 256 with one KV head and a
  window, and at a ragged length against the oracle.

Tests marked `gpu` run the CUDA kernels against the plain versions and
skip where no GPU is visible.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire_compress as jwc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import wire_quant as jwq
from repro_torch.core import wire_compress as twc
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.splitcat_linear import (splitcat_linear_plain,
                                                 splitcat_linear_q8_plain)


def _payload(seed, shape, *, zero_rows=()):
    """fp32 rows with scales spread from 0.01 to 50 (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    rows = x.reshape(-1, shape[-1]) if shape else x.reshape(1, 1)
    rows *= np.logspace(-2, np.log10(50.0), rows.shape[0],
                        dtype=np.float32)[:, None]
    for r in zero_rows:
        rows[r] = 0.0
    return rows.reshape(shape)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a torch tensor and a jax array; bf16 is rounded
    once (by torch) and handed over exactly through float32."""
    t = torch.from_numpy(x)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return t, jnp.asarray(x)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _halves(seed, shape):
    """Rows whose absmax is 127 * 2^e and whose other values are
    +-(k + 1/2) * 2^e, k = 0..126, shuffled: the row scale is exactly 2^e,
    so every quotient is a half and rounds to the even neighbour."""
    rng = np.random.default_rng(seed)
    k = np.arange(127, dtype=np.float32) + np.float32(0.5)
    rows = []
    for e in np.arange(shape[0]) * 4 - 3:
        row = np.concatenate([[127.0], k, -k]).astype(np.float32)
        rows.append(rng.permutation(row) * np.float32(2.0 ** e))
    return np.stack(rows).reshape(shape)


def _near_halves(seed, shape):
    """fp32 rows of random absmax a whose values are RN((k + 1/2) s) and
    its two float32 neighbours, s = RN(a * f32(1/127)): quotients on and
    one ulp either side of the halves, where a quotient that is not the
    IEEE one rounds to the other integer."""
    rng = np.random.default_rng(seed)
    rows = np.empty((int(np.prod(shape[:-1])), shape[-1]), np.float32)
    for r in rows:
        a = np.float32(abs(rng.standard_normal()) * 10.0 ** rng.uniform(-6, 3))
        s = np.float32(a * np.float32(ref.INV127))
        m = (rng.integers(-127, 127, r.size) + np.float32(0.5)) * s
        step = rng.integers(-1, 2, r.size)
        r[:] = np.where(step == 0, m, np.nextafter(
            m, np.where(step > 0, np.inf, -np.inf).astype(np.float32)))
        r[rng.integers(r.size)] = a
    return rows.reshape(shape)


def _wire_input(seed, shape, zeros):
    if zeros == "halves":
        return _halves(seed, shape)
    if zeros == "near_halves":
        return _near_halves(seed, shape)
    return _payload(seed, shape, zero_rows=zeros)


WIRE_CASES = [
    ((4, 1, 3072), "float32", ()),
    ((4, 1, 3072), "bfloat16", ()),
    ((5, 3, 17), "float32", (0, 7)),        # ragged rows + rows of zeros
    ((2, 7, 97), "bfloat16", (3,)),
    ((3, 200), "float32", ()),
    ((1,), "float32", ()),
    ((), "float32", ()),                    # 0-d leaf
    ((2, 1, 20001), "bfloat16", (1,)),      # wide, ragged, a row of zeros
    ((3, 255), "float32", "halves"),        # round half to even
    ((3, 255), "bfloat16", "halves"),
    ((4, 384), "float32", "near_halves"),   # quotients at the halves' ulps
]
WIRE_IDS = [f"{'x'.join(map(str, s)) or '0d'}-{d}"
            + (f"-{z.replace('_', '-')}" if isinstance(z, str) else "")
            for s, d, z in WIRE_CASES]


@pytest.mark.parametrize("shape,dtype,zeros", WIRE_CASES, ids=WIRE_IDS)
def test_wire_quantize_bitwise_vs_reference(shape, dtype, zeros):
    x_t, x_j = _pair(_wire_input(0, shape, zeros), dtype)
    q, s = ops.wire_quantize(x_t)
    q_int, s_int = jops.wire_quantize(x_j, interpret=True)
    x_rows = x_j if shape else x_j[None]
    q_ref, s_ref = jref.wire_quant_ref(x_rows)
    if not shape:
        q_ref, s_ref = q_ref[0], s_ref[0]
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == shape
    assert tuple(s.shape) == (shape[:-1] + (1,) if shape else ())
    for qj, sj in ((q_int, s_int), (q_ref, s_ref)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))


@pytest.mark.parametrize("shape,dtype,zeros", WIRE_CASES, ids=WIRE_IDS)
def test_wire_dequantize_and_fake_quant_bitwise(shape, dtype, zeros):
    x_t, x_j = _pair(_wire_input(1, shape, zeros), dtype)
    q_j, s_j = jops.wire_quantize(x_j, interpret=True)
    q, s = torch.from_numpy(np.array(q_j)), torch.from_numpy(np.array(s_j))
    for out in ("float32", "bfloat16"):
        d = ops.wire_dequantize(q, s, getattr(torch, out))
        d_j = jops.wire_dequantize(q_j, s_j, jnp.dtype(out), interpret=True)
        np.testing.assert_array_equal(_np(d), _np(d_j))
    fake = twc._fake_quant_int8(x_t)
    np.testing.assert_array_equal(_np(fake), _np(jwc._fake_quant_int8(x_j)))
    # the physical wire's identity: dequant(pack(x)) == fake_quant(x)
    np.testing.assert_array_equal(_np(twc.unpack_int8(twc.pack_int8(x_t))),
                                  _np(fake))


def test_halves_round_to_even():
    x = torch.from_numpy(_halves(2, (3, 255)))
    q, s = ops.wire_quantize(x)
    assert torch.equal(s[:, 0], torch.tensor([2.0 ** -3, 2.0, 2.0 ** 5]))
    half = (x / s).abs() % 1 == 0.5
    assert int(half.sum()) == 3 * 254
    assert bool((q[half] % 2 == 0).all())


ROUNDTRIP_CASES = [((5, 40), "float32"), ((3, 7, 33), "bfloat16"),
                   ((), "float32")]


@pytest.mark.parametrize("shape,dtype", ROUNDTRIP_CASES,
                         ids=[f"{'x'.join(map(str, s)) or '0d'}-{d}"
                              for s, d in ROUNDTRIP_CASES])
def test_wire_roundtrip_value_and_gradient_vs_reference(shape, dtype):
    """Forward dequant(quant(x)) and the custom backward (the cotangent
    through the same int8 wire), bitwise against jax.vjp of the
    reference's `wire_roundtrip`."""
    x_t, x_j = _pair(_payload(8, shape), dtype)
    g_t, g_j = _pair(_payload(9, shape), dtype)
    out_j, vjp = jax.vjp(jwq.wire_roundtrip, x_j)
    (grad_j,) = vjp(g_j)
    x_t.requires_grad_(True)
    out = ops.wire_roundtrip(x_t)
    out.backward(g_t)
    assert out.dtype == x_t.dtype and tuple(out.shape) == shape
    np.testing.assert_array_equal(_np(out.detach()), _np(out_j))
    np.testing.assert_array_equal(_np(x_t.grad), _np(grad_j))
    np.testing.assert_array_equal(_np(out.detach()),
                                  _np(twc._fake_quant_int8(x_t.detach())))


def test_quant_constants_are_the_reference_float32_values():
    assert np.float32(ref.INV127) == np.float32(1.0) / np.float32(127.0)
    assert ref.INV127 == float(np.float32(1.0 / 127.0))
    assert ref.EPS == float(np.float32(1e-12))


def test_packed_payload_bytes_and_stacking():
    x = torch.from_numpy(_payload(2, (3, 1, 16)))
    parts = [twc.pack_int8(x[i:i + 1]) for i in range(3)]
    stacked = twc.stack_packed(parts)
    whole = twc.pack_int8(x)
    assert torch.equal(stacked.q, whole.q)
    assert torch.equal(stacked.scale, whole.scale)
    assert twc.payload_nbytes(whole) == 3 * 16 + 3 * 4
    assert twc.payload_nbytes(whole) == twc.wire_bytes((3, 1, 16),
                                                       quantized=True)
    assert whole.shape == (3, 1, 16) and whole.dtype == torch.float32


def _q8_inputs(seed, widths, lead, cols, bias):
    rng = np.random.default_rng(seed)
    qs, ss = [], []
    for k in widths:
        x = _payload(int(rng.integers(1 << 30)), lead + (k,))
        q, s = jref.wire_quant_ref(jnp.asarray(x))
        qs.append(np.array(q))
        ss.append(np.array(s))
    w = (rng.standard_normal((sum(widths), cols)) / 16).astype(np.float32)
    b = rng.standard_normal((cols,)).astype(np.float32) if bias else None
    return qs, ss, w, b


Q8_CASES = [((128,), (2, 1), 384, False),          # fused entry shape
            ((128,), (3, 5), 131, True),           # odd width + bias
            ((96, 33), (7,), 200, True),           # two parts, odd K
            ((64, 31), (2, 3), 97, False)]


@pytest.mark.parametrize("widths,lead,cols,bias", Q8_CASES,
                         ids=[f"{len(c[0])}part-c{c[2]}-b{int(c[3])}"
                              for c in Q8_CASES])
def test_splitcat_linear_q8_vs_reference(widths, lead, cols, bias):
    qs, ss, w, b = _q8_inputs(3, widths, lead, cols, bias)
    y = ops.splitcat_linear_q8(
        [torch.from_numpy(q) for q in qs], [torch.from_numpy(s) for s in ss],
        torch.from_numpy(w), None if b is None else torch.from_numpy(b))
    assert tuple(y.shape) == lead + (cols,) and y.dtype == torch.float32
    jargs = ([jnp.asarray(q) for q in qs], [jnp.asarray(s) for s in ss],
             jnp.asarray(w), None if b is None else jnp.asarray(b))
    y_int = jops.splitcat_linear_q8(*jargs, interpret=True)
    y_ref = jref.splitcat_linear_q8_ref(*jargs)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_int), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)
    # the torch copy of the reference's oracle agrees too
    y_tref = ref.splitcat_linear_q8_ref(
        [torch.from_numpy(q) for q in qs], [torch.from_numpy(s) for s in ss],
        torch.from_numpy(w), None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(y_tref.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)


def test_splitcat_q8_bf16_output_and_row_check():
    qs, ss, w, _ = _q8_inputs(4, (64,), (2, 1), 48, False)
    args = ([torch.from_numpy(q) for q in qs],
            [torch.from_numpy(s) for s in ss])
    y = ops.splitcat_linear_q8(*args, torch.from_numpy(w),
                               out_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    y32 = splitcat_linear_q8_plain(*args, torch.from_numpy(w))
    assert torch.equal(y, y32.to(torch.bfloat16))
    with pytest.raises(ValueError, match="sum K_i"):
        ops.splitcat_linear_q8(*args, torch.from_numpy(w[:-1]))


def test_cpu_and_meta_tensors_launch_nothing():
    ops.reset_launches()
    x = torch.from_numpy(_payload(5, (2, 8)))
    q, s = ops.wire_quantize(x)
    ops.wire_dequantize(q, s)
    ops.splitcat_linear_q8([q], [s], torch.ones(8, 3))
    ops.splitcat_linear([x, x], torch.ones(16, 3))
    m = ops.wire_quantize(x.to("meta"))
    assert m[0].device.type == "meta" and tuple(m[1].shape) == (2, 1)
    y = ops.splitcat_linear([x.to("meta")], torch.ones(8, 3, device="meta"))
    assert y.device.type == "meta" and tuple(y.shape) == (2, 3)
    y = ops.rmsnorm(x, torch.ones(8))
    assert tuple(y.shape) == (2, 8)
    assert ops.rmsnorm(x.to("meta"), torch.ones(8, device="meta")).is_meta
    (xs, dt, A, Bm, Cm), _ = _ssd_np(1, 8, 2, 1, 4, 4, torch.float32)
    y, st = ops.ssd_scan(xs, dt, A, Bm, Cm, chunk=4, return_state=True)
    assert tuple(y.shape) == (2, 8, 2, 4) and tuple(st.shape) == (2, 2, 4, 4)
    ym = ops.ssd_scan(*(t.to("meta") for t in (xs, dt, A, Bm, Cm)), chunk=8)
    assert ym.is_meta and tuple(ym.shape) == (2, 8, 2, 4)
    (q, k, v), _ = _flash_inputs(2, 1, 8, 4, 2, 32, "float32")
    assert tuple(ops.flash_attention(q, k, v, window=3).shape) == (1, 8, 4, 32)
    om = ops.flash_attention(*(t.to("meta") for t in (q, k, v)))
    assert om.is_meta and tuple(om.shape) == (1, 8, 4, 32)
    assert ops.launch_counts() == {"wire_quant": 0, "wire_dequant": 0,
                                   "splitcat_linear_q8": 0,
                                   "splitcat_linear": 0, "rmsnorm": 0,
                                   "ssd_scan": 0, "flash_attention": 0}


def test_build_targets_sm90a_without_fast_math():
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    for src in build.SOURCES.values():
        text = (build.CSRC / src).read_text()
        assert "Replaces the TPU kernel" in text
        assert "roundf(" not in text            # rintf: half to even


# ---------------------------------------------------------------------------
# the dense splitcat entry
# ---------------------------------------------------------------------------

# tests/test_kernels.py's sweep: part widths and d_out
SPLITCAT_DIMS = [((128,), 256), ((128, 128), 256), ((192, 64, 128), 384),
                 ((256, 256), 128), ((96, 33, 7), 131)]
# fp32: the sums run in another order; bf16: the reference's own
# tolerance for its bf16 sweep (one rounding of the output)
SPLITCAT_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
                "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _splitcat_inputs(seed, part_dims, d_out, dtype, bias, lead=(3, 17)):
    rng = np.random.default_rng(seed)
    parts = [0.5 * rng.standard_normal((*lead, d)).astype(np.float32)
             for d in part_dims]
    w = 0.05 * rng.standard_normal((sum(part_dims), d_out)).astype(np.float32)
    b = rng.standard_normal((d_out,)).astype(np.float32) if bias else None
    pairs = [_pair(p, dtype) for p in parts]
    w_t, w_j = _pair(w, dtype)
    b_t, b_j = _pair(b, dtype) if bias else (None, None)
    return ([t for t, _ in pairs], w_t, b_t), ([j for _, j in pairs], w_j,
                                               b_j)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", SPLITCAT_DIMS,
                         ids=["x".join(map(str, d[0])) + f"-c{d[1]}"
                              for d in SPLITCAT_DIMS])
def test_splitcat_linear_vs_reference(dims, dtype, bias):
    (parts, w, b), jargs = _splitcat_inputs(8, *dims, dtype, bias)
    y = ops.splitcat_linear(parts, w, b)
    assert y.dtype == parts[0].dtype and tuple(y.shape) == (3, 17, dims[1])
    y_int = jops.splitcat_linear(*jargs, interpret=True)
    y_ref = jref.splitcat_linear_ref(*jargs)
    for want in (y_int, y_ref):
        np.testing.assert_allclose(_np(y), _np(want), **SPLITCAT_TOL[dtype])
    # the torch copy of the oracle (one concat, one matmul) agrees too
    np.testing.assert_allclose(_np(ref.splitcat_linear_ref(parts, w, b)),
                               _np(y), **SPLITCAT_TOL[dtype])


def test_splitcat_packed_over_dense_parts_matches_reference():
    (parts, w, b), (pj, wj, bj) = _splitcat_inputs(9, (40, 24), 12,
                                                   "float32", True)
    y = twc.splitcat_linear_packed(parts, w, b)
    y_j = jwc.splitcat_linear_packed(pj, wj, bj)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5,
                               atol=1e-5)
    # a mixed list densifies first, as the reference does
    packed = twc.pack_int8(parts[0])
    mixed = twc.splitcat_linear_packed([packed, parts[1]], w, b)
    mixed_j = jwc.splitcat_linear_packed(
        [jwc.pack_int8(pj[0]), pj[1]], wj, bj)
    np.testing.assert_allclose(mixed.numpy(), np.asarray(mixed_j),
                               rtol=1e-5, atol=1e-5)


def test_splitcat_linear_checks_its_inputs():
    x = torch.ones(2, 4)
    with pytest.raises(ValueError, match="sum K_i"):
        ops.splitcat_linear([x, x], torch.ones(7, 3))
    assert torch.equal(splitcat_linear_plain([x, 2 * x], torch.ones(8, 3)),
                       torch.full((2, 3), 12.0))


# ---------------------------------------------------------------------------
# rmsnorm and the SSD scan
# ---------------------------------------------------------------------------

RMS_SHAPES = [(4, 128), (2, 7, 256), (1, 33, 512), (3, 1, 128), (5, 77, 128)]


def _rms_inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    sc = (0.1 * rng.standard_normal(shape[-1:]) + 1.0).astype(np.float32)
    return _pair(x, dtype), _pair(sc, dtype)


def _within_bf16_ulp(got, want32):
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want32), 2.0 ** -126)))
                  - 7)
    return bool((np.abs(got - want32) <= ulp).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SHAPES,
                         ids=["x".join(map(str, s)) for s in RMS_SHAPES])
def test_rmsnorm_vs_reference(shape, dtype):
    (x, xj), (sc, scj) = _rms_inputs(11, shape, dtype)
    y = ops.rmsnorm(x, sc)
    assert y.dtype == x.dtype and y.shape == x.shape
    y_int = jops.rmsnorm(xj, scj, interpret=True)
    y_ref = jref.rmsnorm_ref(xj, scj)
    for want in (y_int, y_ref):
        if dtype == "float32":
            np.testing.assert_allclose(_np(y), _np(want), rtol=1e-6,
                                       atol=1e-6)
        else:   # both round one float32 value, which differs in its last bits
            want32 = jref.rmsnorm_ref(xj.astype(jnp.float32),
                                      scj.astype(jnp.float32))
            assert _within_bf16_ulp(_np(y), _np(want32))
            assert _within_bf16_ulp(_np(want), _np(want32))
    np.testing.assert_array_equal(_np(ref.rmsnorm_ref(x, sc)), _np(y))


def _ssd_np(seed, s, h, g, p, n, dtype):
    """The sweep's inputs (numpy, seeded) as torch tensors and jax arrays;
    A stays float32, as in the model."""
    rng = np.random.default_rng(seed)
    b = 2
    x = 0.5 * rng.standard_normal((b, s, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
    A = -np.exp(0.2 * rng.standard_normal(h))
    Bm = 0.3 * rng.standard_normal((b, s, g, n))
    Cm = 0.3 * rng.standard_normal((b, s, g, n))
    arrs = [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]
    tdt = torch.float32 if dtype in ("float32", torch.float32) \
        else torch.bfloat16
    ts = [torch.from_numpy(a).to(tdt if i != 2 else torch.float32)
          for i, a in enumerate(arrs)]
    js = [jnp.asarray(t.float().numpy()).astype(
        jnp.float32 if i == 2 or tdt == torch.float32 else jnp.bfloat16)
        for i, t in enumerate(ts)]
    return ts, js


SSD_SWEEP = [(64, 2, 1, 32, 16, 16), (128, 4, 2, 16, 32, 32),
             (96, 3, 3, 64, 8, 32)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,g,p,n,chunk", SSD_SWEEP,
                         ids=[f"s{c[0]}h{c[1]}g{c[2]}" for c in SSD_SWEEP])
def test_ssd_scan_vs_reference(s, h, g, p, n, chunk, dtype):
    ts, js = _ssd_np(12, s, h, g, p, n, dtype)
    y = ops.ssd_scan(*ts, chunk=chunk)
    assert y.dtype == ts[0].dtype and tuple(y.shape) == (2, s, h, p)
    tol = (dict(rtol=1e-4, atol=1e-4) if dtype == "float32"
           else dict(rtol=5e-2, atol=5e-2))
    for want in (jops.ssd_scan(*js, chunk=chunk, interpret=True),
                 jref.ssd_scan_ref(*js)):
        np.testing.assert_allclose(_np(y), _np(want), **tol)
    if dtype == "float32":      # the port's O(S) oracle is the reference's
        np.testing.assert_allclose(_np(ref.ssd_scan_ref(*ts)),
                                   _np(jref.ssd_scan_ref(*js)), rtol=1e-5,
                                   atol=1e-5)


def test_ssd_scan_state_chains_and_checks_its_inputs():
    """Two calls chained through the returned state equal one call over
    the whole sequence; a ragged chunk raises on every device."""
    ts, _ = _ssd_np(13, 48, 4, 2, 16, 8, torch.float32)
    y, st = ops.ssd_scan(*ts, chunk=16, return_state=True)
    first = [t[:, :32] if t.ndim > 1 else t for t in ts]
    rest = [t[:, 32:] if t.ndim > 1 else t for t in ts]
    y1, st1 = ops.ssd_scan(*first, chunk=16, return_state=True)
    y2, st2 = ops.ssd_scan(*rest, chunk=16, initial_state=st1,
                           return_state=True)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(st2, st, rtol=1e-5, atol=1e-5)
    with pytest.raises(AssertionError, match="chunk"):
        ops.ssd_scan(*ts, chunk=20)


def test_ssd_chunk_length_changes_only_rounding():
    """The SSD does not depend on the chunk length beyond rounding: at the
    model's 512 rows and decay rates (A from -1 to -16), the float32
    chunked form at the CUDA kernel's 64-row tile and at the model's
    chunk of 256 agree within the tolerance the card check uses against
    the kernel, 1e-3 x rms + 1e-4 x |y|, and both sit within it of a
    float64 evaluation."""
    from repro_torch.kernels.ssd_scan import ssd_chunked_plain
    g = torch.Generator().manual_seed(0)
    b, s, h, p, n = 1, 512, 24, 16, 32
    x = 0.5 * torch.randn((b, s, h, p), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g))
    A = -torch.linspace(1.0, 16.0, h)
    Bm, Cm = (0.3 * torch.randn((b, s, 1, n), generator=g) for _ in range(2))
    init = torch.randn((b, h, p, n), generator=g)
    y64 = ref.ssd_scan_ref(x.double(), dt.double(), A.double(),
                           Bm.double(), Cm.double())
    ys = [ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=c) for c in (64, 256)]
    assert y64.dtype == torch.float64
    for got, want in ((ys[0], ys[1]), (ys[0], y64), (ys[1], y64)):
        tol = 1e-3 * want.square().mean().sqrt() + 1e-4 * want.abs()
        assert bool(((got.double() - want.double()).abs() <= tol).all())
    # with a carried state too
    y_a, st_a = ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=64,
                                  initial_state=init, return_state=True)
    y_b, st_b = ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=256,
                                  initial_state=init, return_state=True)
    for got, want in ((y_a, y_b), (st_a, st_b)):
        tol = 1e-3 * want.square().mean().sqrt() + 1e-4 * want.abs()
        assert bool(((got - want).abs() <= tol).all())


def _ssd_kernel_order(x, dt, A, Bm, Cm, init=None, tile=64):
    """The CUDA kernel's association in plain float32 torch (a test
    helper): per 64-row tile the running log decay as the kernel's warp
    scan sums it (pair sums, a Kogge-Stone scan over 32 lanes, each pair
    finished from the lanes before it), the intra-tile term, the tile's
    state increment dS = x^T (dt_s exp(cum_last - cum_s) B_s), the carry
    S_in(c + 1) = exp(cum_last) S_in(c) + dS(c), and the inter term
    exp(cum_t) C_t S_in(c)."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    t = -(-s // tile)
    pad = t * tile - s

    def tiles(v):   # (b, s, ...) -> (b, t, tile, ...), zero rows past s
        v = torch.nn.functional.pad(v.float(), (0, 0) * (v.ndim - 2)
                                    + (0, pad))
        return v.reshape(b, t, tile, *v.shape[2:])
    dtt = tiles(dt)                                       # (b,t,q,h)
    xd = tiles(x) * dtt[..., None]                        # (b,t,q,h,p)
    Bt = tiles(Bm).repeat_interleave(h // g, dim=3)       # (b,t,q,h,n)
    Ct = tiles(Cm).repeat_interleave(h // g, dim=3)
    pairs = (dtt * A).reshape(b, t, tile // 2, 2, h)
    run = pairs[:, :, :, 0] + pairs[:, :, :, 1]
    d = 1
    while d < tile // 2:
        run = torch.cat([run[:, :, :d], run[:, :, d:] + run[:, :, :-d]], 2)
        d *= 2
    excl = torch.cat([torch.zeros_like(run[:, :, :1]), run[:, :, :-1]], 2)
    c0 = excl + pairs[:, :, :, 0]
    cum = torch.stack([c0, c0 + pairs[:, :, :, 1]], 3).reshape(b, t, tile, h)

    dw = dtt * torch.exp(cum[:, :, -1:] - cum)             # dt_s w_s
    dS = torch.einsum("bcshp,bcshn->bchpn", tiles(x), Bt * dw[..., None])
    decay = torch.exp(cum[:, :, -1])                      # (b,t,h)
    state = (torch.zeros((b, h, p, n)) if init is None else init.float())
    s_in = []
    for c in range(t):
        s_in.append(state)
        state = decay[:, c, :, None, None] * state + dS[:, c]
    mask = torch.tril(torch.ones((tile, tile), dtype=torch.bool))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,t,q_t,q_s,h)
    cb = torch.einsum("bcthn,bcshn->bctsh", Ct, Bt)
    m = torch.where(mask[None, None, :, :, None],
                    cb * torch.exp(seg.masked_fill(
                        ~mask[None, None, :, :, None], 0.0)), 0.0)
    intra = torch.einsum("bctsh,bcshp->bcthp", m, xd)
    inter = torch.einsum("bcthn,bchpn->bcthp", Ct,
                         torch.stack(s_in, 1)) * torch.exp(cum)[..., None]
    y = (intra + inter).reshape(b, t * tile, h, p)[:, :s]
    return y, state


def _ssd_recurrence64(x, dt, A, Bm, Cm, init=None):
    """The SSD's O(S) recurrence in float64 from a state, -> (y, final
    state)."""
    b, s, h, p = x.shape
    rep = h // Bm.shape[2]
    x, dt, A, Bm, Cm = (v.double() for v in (x, dt, A, Bm, Cm))
    state = (torch.zeros((b, h, p, Bm.shape[3]), dtype=torch.float64)
             if init is None else init.double())
    ys = []
    for i in range(s):
        Bh = Bm[:, i].repeat_interleave(rep, 1)
        Ch = Cm[:, i].repeat_interleave(rep, 1)
        state = (state * torch.exp(dt[:, i] * A)[:, :, None, None]
                 + torch.einsum("bhp,bhn->bhpn", x[:, i] * dt[:, i, :, None],
                                Bh))
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch))
    return torch.stack(ys, 1), state


@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_ssd_kernel_association_at_the_model_decay_rates(carried):
    """The CUDA kernel's order of work (`_ssd_kernel_order`: 64-row tiles,
    the warp scan, dS, the carry across tiles, intra + inter) at the
    model's 512 rows and decay rates (A from -1 to -16), against a float64
    evaluation and against the plain chunked form at the model's chunk of
    256, within the card check's 1e-3 x rms + 1e-4 x |v|, for y and the
    final state, from a zero and from a carried state."""
    from repro_torch.kernels.ssd_scan import ssd_chunked_plain
    g = torch.Generator().manual_seed(1)
    b, s, h, p, n = 1, 512, 24, 16, 32
    x = 0.5 * torch.randn((b, s, h, p), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g))
    A = -torch.linspace(1.0, 16.0, h)
    Bm, Cm = (0.3 * torch.randn((b, s, 1, n), generator=g) for _ in range(2))
    init = torch.randn((b, h, p, n), generator=g) if carried else None
    y, st = _ssd_kernel_order(x, dt, A, Bm, Cm, init)
    y64, st64 = _ssd_recurrence64(x, dt, A, Bm, Cm, init)
    y256, st256 = ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=256,
                                    initial_state=init, return_state=True)
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, s, h, p)
    for got, want in ((y, y64), (st, st64), (y, y256), (st, st256)):
        tol = 1e-3 * want.square().mean().sqrt() + 1e-4 * want.abs()
        assert bool(((got.double() - want.double()).abs() <= tol).all())


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# tests/test_kernels.py's causal sweep: (S, H, K, D)
FLASH_SWEEP = [(128, 4, 4, 64), (256, 4, 2, 64), (128, 8, 1, 128),
               (64, 2, 2, 32)]
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _flash_inputs(seed, b, s, h, k, d, dtype):
    """(q, k, v) as torch tensors and as jax arrays, standard normal."""
    rng = np.random.default_rng(seed)
    pairs = [_pair(rng.standard_normal((b, s, n, d)).astype(np.float32),
                   dtype) for n in (h, k, k)]
    return [t for t, _ in pairs], [j for _, j in pairs]


def _flash_expected(jargs, **kw):
    """The reference's interpret-mode kernel (64-row blocks) and its
    oracle over the KV heads repeated, as tests/test_kernels.py runs
    them."""
    q, k, v = jargs
    rep = q.shape[2] // k.shape[2]
    out = jops.flash_attention(q, k, v, block_q=64, block_kv=64,
                               interpret=True, **kw)
    oracle = jref.flash_attention_ref(q, jnp.repeat(k, rep, 2),
                                      jnp.repeat(v, rep, 2), **kw)
    return out, oracle


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,h,k,d", FLASH_SWEEP,
                         ids=[f"s{c[0]}h{c[1]}k{c[2]}d{c[3]}"
                              for c in FLASH_SWEEP])
def test_flash_attention_causal_vs_reference(s, h, k, d, dtype):
    targs, jargs = _flash_inputs(20, 2, s, h, k, d, dtype)
    y = ops.flash_attention(*targs, causal=True)
    assert y.dtype == targs[0].dtype and tuple(y.shape) == (2, s, h, d)
    for want in _flash_expected(jargs, causal=True):
        np.testing.assert_allclose(_np(y), _np(want), **FLASH_TOL[dtype])


@pytest.mark.parametrize("causal,window,shape", [
    (True, 32, (256, 2, 2, 64)), (True, 64, (256, 2, 2, 64)),
    (True, 100, (256, 2, 2, 64)), (False, None, (128, 2, 2, 64)),
    (True, 100, (128, 4, 1, 256))],
    ids=["window32", "window64", "window100", "noncausal",
         "d256-kv1-window100"])
def test_flash_attention_window_and_noncausal_vs_reference(causal, window,
                                                           shape):
    targs, jargs = _flash_inputs(21, 1, *shape, "float32")
    y = ops.flash_attention(*targs, causal=causal, window=window)
    for want in _flash_expected(jargs, causal=causal, window=window):
        np.testing.assert_allclose(_np(y), _np(want), **FLASH_TOL["float32"])


@pytest.mark.parametrize("window", [None, 30])
def test_flash_attention_ragged_length_vs_oracle(window):
    """A length that is no multiple of any tile (the reference's kernel
    asserts S % block == 0; the port takes any S), against the oracle;
    the plain version is the served models' grouped attention."""
    targs, (q, k, v) = _flash_inputs(22, 2, 100, 4, 2, 32, "float32")
    y = ops.flash_attention(*targs, window=window)
    want = jref.flash_attention_ref(q, jnp.repeat(k, 2, 2),
                                    jnp.repeat(v, 2, 2), causal=True,
                                    window=window)
    np.testing.assert_allclose(_np(y), _np(want), **FLASH_TOL["float32"])
    mask = ref.causal_mask(100, 100, window=window)
    assert torch.equal(y, ref.grouped_attention(*targs, mask,
                                                scale=32 ** -0.5))


def _bf16_ulp_floored(want32: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each float32 value, floored at 1/256 of the rms:
    the check `chip_smoke.py:_bf16_ulp` makes (where a sum cancels to near
    zero, two float32 summation orders differ by more than a bf16 ulp of
    the tiny result)."""
    floor = max(2.0 ** -126, want32.square().mean().sqrt().item() / 256)
    return torch.exp2(torch.floor(torch.log2(want32.abs().clamp_min(floor)))
                      - 7)


def _flash_pieces_emulated(q, k, v, *, pieces: int, window=None):
    """The bf16 CUDA kernel's rounding in plain torch (a test helper, never
    on the main path): scores of bf16 q and k in float32, the online
    softmax over 64-row KV tiles in float32, and P cut into `pieces` bf16
    pieces (each the rounding of what the earlier left), each piece's
    product with V accumulated in float32; the output rounded once."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]
    kf = k.float().repeat_interleave(rep, 2)
    vf = v.float().repeat_interleave(rep, 2)
    mask = ref.causal_mask(S, S, window=window)
    m = torch.full((B, H, S, 1), ref.NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    for t0 in range(0, S, 64):
        s = torch.einsum("bshd,bthd->bhst", q.float(),
                         kf[:, t0:t0 + 64]) * D ** -0.5
        s = torch.where(mask[:, t0:t0 + 64], s, ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha
        for _ in range(pieces):
            piece = p.to(torch.bfloat16).float()
            acc = acc + torch.einsum("bhst,bthd->bhsd", piece,
                                     vf[:, t0:t0 + 64])
            p = p - piece
        m = m_new
    out = acc / l.clamp_min(1e-30)
    return out.transpose(1, 2).to(torch.bfloat16)


def _flash_f64_bound(targs, window):
    """The float64 plain result of the (bf16) inputs, each output's
    condition sum_j |p_j| |v_j| / l, and the bound a bf16 output must
    keep from the float64 value: one bf16 ulp of it (unfloored) plus
    n_keys 2^-24 sum|p||v|/l, the worst-case error of a float32 sum of
    the row's n_keys weighted values."""
    q, k, v = (t.double() for t in targs)
    want64 = ref.flash_attention_ref(q, k, v, window=window)
    cond = ref.flash_attention_ref(q, k, v.abs(), window=window)
    pos = torch.arange(q.shape[1], device=q.device, dtype=torch.float64)
    n_keys = pos + 1 if window is None else (pos + 1).clamp_max(window)
    ulp = torch.exp2(torch.floor(torch.log2(
        want64.abs().clamp_min(2.0 ** -126))) - 7)
    bound = ulp + n_keys[None, :, None, None] * 2.0 ** -24 * cond
    return want64, cond, bound


FLASH_PIECES = [(2, s, h, k, d, None) for s, h, k, d in FLASH_SWEEP] + [
    (1, 300, 4, 1, 256, 70)]


@pytest.mark.parametrize("b,s,h,k,d,window", FLASH_PIECES,
                         ids=[f"s{c[1]}h{c[2]}k{c[3]}d{c[4]}w{c[5]}"
                              for c in FLASH_PIECES])
def test_flash_three_bf16_pieces_of_p_within_one_ulp(b, s, h, k, d, window):
    """The kernel's p v as three bf16 products of the pieces of P holds the
    float32 plain result to 1 bf16 ulp (floored, as chip_smoke.py
    checks), like float32 P."""
    targs, _ = _flash_inputs(24, b, s, h, k, d, "bfloat16")
    want32 = ref.flash_attention_ref(*(t.float() for t in targs),
                                     window=window)
    y = _flash_pieces_emulated(*targs, pieces=3, window=window)
    assert bool(((y.float() - want32).abs()
                 <= _bf16_ulp_floored(want32)).all())


@pytest.mark.parametrize("b,s,h,k,d,window", FLASH_PIECES,
                         ids=[f"s{c[1]}h{c[2]}k{c[3]}d{c[4]}w{c[5]}"
                              for c in FLASH_PIECES])
def test_flash_fewer_pieces_of_p_lose_precision(b, s, h, k, d, window):
    """Why P is cut in pieces: P rounded to bf16 once leaves outputs
    beyond 1 bf16 ulp of the float32 plain result; two pieces (P_hi +
    P_lo, about 2^-17) stay within it at these sizes but stand nearer its
    edge than three (float32's 2^-24); on the card, a two-piece kernel
    left outputs beyond it."""
    targs, _ = _flash_inputs(24, b, s, h, k, d, "bfloat16")
    want32 = ref.flash_attention_ref(*(t.float() for t in targs),
                                     window=window)
    ulp = _bf16_ulp_floored(want32)
    worst = {n: ((_flash_pieces_emulated(*targs, pieces=n, window=window)
                  .float() - want32).abs() / ulp).max().item()
             for n in (1, 2, 3)}
    assert worst[1] > 1.0 >= worst[2] > worst[3]


@pytest.mark.parametrize("b,s,h,k,d,window", FLASH_PIECES,
                         ids=[f"s{c[1]}h{c[2]}k{c[3]}d{c[4]}w{c[5]}"
                              for c in FLASH_PIECES])
def test_flash_three_bf16_pieces_within_the_float64_bound(b, s, h, k, d,
                                                          window):
    """The card test's bf16 check on the kernel's rounding emulated in
    plain torch: within one bf16 ulp of the float64 plain result plus the
    float32 sum's worst case over the row's keys."""
    targs, _ = _flash_inputs(24, b, s, h, k, d, "bfloat16")
    want64, _, bound = _flash_f64_bound(targs, window)
    y = _flash_pieces_emulated(*targs, pieces=3, window=window)
    assert want64.dtype == torch.float64
    assert bool(((y.double() - want64).abs() <= bound).all())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,zeros", WIRE_CASES, ids=WIRE_IDS)
def test_wire_kernels_on_card_bitwise(cuda, shape, dtype, zeros):
    x, _ = _pair(_wire_input(6, shape, zeros), dtype)
    x = x.to(cuda)
    q, s = ops.wire_quantize(x)
    q_ref, s_ref = ref.wire_quant_ref(x if shape else x[None])
    assert torch.equal(q.reshape(q_ref.shape), q_ref)
    assert torch.equal(s.reshape(s_ref.shape), s_ref)
    d = ops.wire_dequantize(q, s, x.dtype)
    assert torch.equal(d, twc._fake_quant_int8(x))


def _offset_view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous view of t's values starting `offset` elements into
    its storage (so off the allocator's 16-byte alignment)."""
    if not offset:
        return t
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.storage_offset() == offset
    return view


# the main paths' wide and large payloads (logits rows of phi4-mini,
# RecurrentGemma and Mamba2, the RecurrentGemma prefill uplink, the
# training payload), an odd wide width, a zero row inside a cluster's
# row, quotients at the halves' ulps in a cluster's row, x or q one
# element off 16-byte alignment (narrow and wide), and rows over 256K
# elements, whose slices go through shared memory
WIRE_CARD = [((4, 1, 200064), "bfloat16", (), 0),
             ((4, 1, 256000), "bfloat16", (), 0),
             ((4, 1, 50280), "bfloat16", (), 0),
             ((2, 1, 200063), "bfloat16", (), 0),
             ((16384, 2560), "bfloat16", (), 0),
             ((128, 512), "float32", (), 0),
             ((3, 1, 200064), "bfloat16", (1,), 0),
             ((3, 1, 50280), "float32", (2,), 0),
             ((2, 1, 60000), "float32", "near_halves", 0),
             ((2, 1, 400000), "bfloat16", (), 0),       # shared memory
             ((2, 1, 1100000), "bfloat16", (1,), 0),
             ((1, 1, 600000), "float32", (), 1),
             ((4, 1, 3072), "bfloat16", (), 1),
             ((5, 2047), "float32", (), 1),
             ((2, 1, 200064), "bfloat16", (), 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,zeros,offset", WIRE_CARD,
                         ids=[f"{'x'.join(map(str, c[0]))}-{c[1]}"
                              + (f"-{c[2].replace('_', '-')}"
                                 if isinstance(c[2], str) else
                                 f"-zero{c[2][0]}" if c[2] else "")
                              + (f"-off{c[3]}" if c[3] else "")
                              for c in WIRE_CARD])
def test_wire_kernels_on_card_at_path_shapes(cuda, shape, dtype, zeros,
                                             offset):
    """Bitwise against the plain versions and the fake quantizer, with x
    (for the quantize) and q (for the dequantize) at `offset`."""
    x, _ = _pair(_wire_input(10, shape, zeros), dtype)
    x = _offset_view(x.to(cuda), offset)
    n = ops.launch_counts()
    q, s = ops.wire_quantize(x)
    q_ref, s_ref = ref.wire_quant_ref(x)
    assert torch.equal(s, s_ref)
    assert torch.equal(q, q_ref)
    for r in () if isinstance(zeros, str) else zeros:
        assert bool((q.reshape(-1, shape[-1])[r] == 0).all())
    fake = twc._fake_quant_int8(x)
    q_in = _offset_view(q, offset)
    for out in {x.dtype, torch.float32}:
        d = ops.wire_dequantize(q_in, s, out)
        assert torch.equal(d, ref.wire_dequant_ref(q, s, out))
    assert torch.equal(ops.wire_dequantize(q_in, s, x.dtype), fake)
    now = ops.launch_counts()
    assert now["wire_quant"] == n["wire_quant"] + 1
    assert now["wire_dequant"] == n["wire_dequant"] + 2 + (
        x.dtype != torch.float32)


@pytest.mark.gpu
def test_wire_quant_raises_for_a_row_past_a_clusters_shared_memory(cuda):
    """No fallback: 8 MB of x a row exceeds 16 blocks' shared memory."""
    x = torch.ones((1, 2_000_000), dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError, match="wire_quant"):
        ops.wire_quantize(x)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", ROUNDTRIP_CASES + [
    ((4, 1, 200064), "bfloat16"), ((128, 512), "float32")],
    ids=lambda c: "x".join(map(str, c)) or "0d" if isinstance(c, tuple)
    else c)
def test_wire_roundtrip_on_card_bitwise(cuda, shape, dtype):
    """Value and gradient through the kernels equal the plain path's."""
    x, _ = _pair(_payload(11, shape), dtype)
    g, _ = _pair(_payload(12, shape), dtype)
    outs = []
    for dev in ("cpu", cuda):
        xd = x.to(dev).detach().requires_grad_(True)
        n = ops.launch_counts()["wire_quant"]
        y = ops.wire_roundtrip(xd)
        y.backward(g.to(dev))
        launched = ops.launch_counts()["wire_quant"] - n
        assert launched == (0 if dev == "cpu" else 2)
        outs.append((y.detach().cpu(), xd.grad.cpu()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# beyond the CPU sweep (fp32 W and output): the phi4-mini decode entry
# (bf16 W and output), a part boundary inside one rank's K range of the
# cluster split and inside a stage, 15 rows, fp32 W whose rows TMA cannot
# address (C = 5121, the kernel's own copy path; at the sweep's K, since
# over K = 4072 at these row scales two float32 summation orders, the
# plain one included, differ from the exact sum by more than 1e-4 at a
# few outputs), and rows past one 16-row tile
Q8_CARD = [c + ("float32", "float32") for c in Q8_CASES] + [
    ((3072,), (4, 1), 5120, False, "bfloat16", "bfloat16"),
    ((1000, 2072), (4, 1), 5120, True, "bfloat16", "float32"),
    ((3072,), (15,), 5120, False, "bfloat16", "bfloat16"),
    ((96, 33), (4, 3), 5121, True, "float32", "float32"),
    ((64, 31), (5, 7), 200, True, "float32", "bfloat16")]


@pytest.mark.gpu
@pytest.mark.parametrize("widths,lead,cols,bias,w_dtype,out_dtype", Q8_CARD,
                         ids=[f"{len(c[0])}part-c{c[2]}-b{int(c[3])}" + (
                             "" if c[4:] == ("float32", "float32") else
                             f"-r{'x'.join(map(str, c[1]))}-w{c[4][:2]}"
                             f"-o{c[5][:2]}") for c in Q8_CARD])
def test_splitcat_q8_kernel_on_card(cuda, widths, lead, cols, bias, w_dtype,
                                    out_dtype):
    """fp32 output at rtol = atol = 1e-4 of the plain version; bf16 output
    within one bf16 ulp (unfloored) of the fp32 plain result."""
    qs, ss, w, b = _q8_inputs(7, widths, lead, cols, bias)
    wd = getattr(torch, w_dtype)
    args = ([torch.from_numpy(q).to(cuda) for q in qs],
            [torch.from_numpy(s).to(cuda) for s in ss],
            torch.from_numpy(w).to(cuda, wd),
            None if b is None else torch.from_numpy(b).to(cuda, wd))
    torch.backends.cuda.matmul.allow_tf32 = False
    n = ops.launch_counts()["splitcat_linear_q8"]
    y = ops.splitcat_linear_q8(*args, out_dtype=getattr(torch, out_dtype))
    assert ops.launch_counts()["splitcat_linear_q8"] == n + 1
    y32 = splitcat_linear_q8_plain(*args)
    if out_dtype == "float32":
        torch.testing.assert_close(y, y32, rtol=1e-4, atol=1e-4)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            y32.abs().clamp_min(2.0 ** -126))) - 7)
        assert y.dtype == torch.bfloat16
        assert bool(((y.float() - y32).abs() <= ulp).all())


# beyond the sweep: K slices (64 deep) that the cluster's split does not
# divide, parts narrower than one slice, rows no multiple of the tiles,
# the evaluation's narrow C = 10
SPLITCAT_CARD = [(d, (3, 17)) for d in SPLITCAT_DIMS] + [
    (((1000, 24), 10), (130,)), (((512, 512), 10), (512,)),
    (((7, 3), 5), (65,)), (((200, 70, 8), 96), (33,)),
    (((256, 128), 512), (4, 64))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims,lead", SPLITCAT_CARD,
                         ids=["x".join(map(str, d[0])) + f"-c{d[1]}"
                              + ("" if lead == (3, 17) else
                                 "-r" + "x".join(map(str, lead)))
                              for d, lead in SPLITCAT_CARD])
def test_splitcat_kernel_on_card(cuda, dims, lead, dtype):
    (parts, w, b), _ = _splitcat_inputs(10, *dims, dtype, True, lead)
    parts = [p.to(cuda) for p in parts]
    w, b = w.to(cuda), b.to(cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    y = ops.splitcat_linear(parts, w, b)
    want = splitcat_linear_plain(parts, w, b)
    if dtype == "float32":
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    else:   # one rounding of the fp32 sum: within 1 bf16 ulp of it
        y32 = splitcat_linear_plain([p.float() for p in parts], w.float(),
                                    b.float())
        ulp = torch.exp2(torch.floor(torch.log2(
            y32.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((y.float() - y32).abs() <= ulp).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RMS_SHAPES,
                         ids=["x".join(map(str, s)) for s in RMS_SHAPES])
def test_rmsnorm_kernel_on_card(cuda, shape, dtype):
    (x, _), (sc, _) = _rms_inputs(14, shape, dtype)
    x, sc = x.to(cuda), sc.to(cuda)
    y = ops.rmsnorm(x, sc)
    want32 = ref.rmsnorm_ref(x.float(), sc.float())
    if dtype == "float32":
        torch.testing.assert_close(y, want32, rtol=1e-5, atol=1e-6)
    else:
        assert _within_bf16_ulp(_np(y.cpu()), _np(want32.cpu()))


# fp32: the CPU sweep and a ragged length; bf16: state groups 1, 2 and 3,
# state sizes 8, 32, 128 and 256 (one prefetch buffer), the Mamba2
# prefill's heads and width, ragged lengths, and x, B and C as views with
# 2-byte-odd token strides (rows TMA cannot address: the kernel reads them
# in place)
SSD_CARD = [c + ("float32", False) for c in SSD_SWEEP] + [
    (100, 4, 1, 24, 8, 50, "float32", False),
    (512, 24, 1, 64, 128, 256, "bfloat16", False),
    (128, 4, 2, 16, 32, 32, "bfloat16", False),
    (96, 3, 3, 64, 8, 32, "bfloat16", False),
    (100, 6, 3, 24, 32, 50, "bfloat16", False),
    (300, 8, 2, 64, 128, 300, "bfloat16", False),
    (64, 2, 1, 32, 256, 64, "bfloat16", False),
    (130, 4, 2, 32, 32, 65, "bfloat16", True)]


def _ssd_card_id(c):
    s, h, g, p, n, _, dtype, odd = c
    if dtype == "float32":
        return "ragged" if s == 100 else f"s{s}h{h}g{g}"
    return f"bf16-s{s}h{h}g{g}p{p}n{n}" + ("-odd" if odd else "")


@pytest.mark.gpu
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
@pytest.mark.parametrize("s,h,g,p,n,chunk,dtype,odd", SSD_CARD,
                         ids=[_ssd_card_id(c) for c in SSD_CARD])
def test_ssd_kernel_on_card(cuda, s, h, g, p, n, chunk, dtype, odd,
                            carried):
    """fp32 at rtol = atol = 1e-4 of the plain version; bf16 (y and the
    state) within 1e-3 x rms + 1e-4 x |v| of the float32 plain result on
    the same inputs, plus one bf16 ulp for y (chip_smoke.py's check)."""
    ts, _ = _ssd_np(15, s, h, g, p, n, dtype)
    ts = [t.to(cuda) for t in ts]
    ts[1] = ts[1].float()           # dt is float32, as the model makes it
    if odd:     # x, B and C inside rows of one value more
        for i, (heads, width) in ((0, (h, p)), (3, (g, n)), (4, (g, n))):
            wide = torch.zeros((2, s, heads * width + 1), dtype=ts[i].dtype,
                               device=cuda)
            wide[..., 1:] = ts[i].reshape(2, s, heads * width)
            ts[i] = wide[..., 1:].unflatten(-1, (heads, width))
    init = (torch.randn((2, h, p, n), generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda) if carried else None)
    n_launch = ops.launch_counts()["ssd_scan"]
    y, st = ops.ssd_scan(*ts, chunk=chunk, initial_state=init,
                         return_state=True)
    assert ops.launch_counts()["ssd_scan"] == n_launch + 1
    from repro_torch.kernels.ssd_scan import ssd_chunked_plain
    if dtype == "float32":
        y_p, st_p = ssd_chunked_plain(*ts, chunk=chunk, initial_state=init,
                                      return_state=True)
        torch.testing.assert_close(y, y_p, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(st, st_p, rtol=1e-4, atol=1e-4)
        return
    y_p, st_p = ssd_chunked_plain(*(t.float() for t in ts), chunk=chunk,
                                  initial_state=init, return_state=True)
    assert y.dtype == torch.bfloat16
    for got, want, ulp in ((y, y_p, True), (st, st_p, False)):
        tol = 1e-3 * want.square().mean().sqrt() + 1e-4 * want.abs()
        if ulp:
            tol = tol + torch.exp2(torch.floor(torch.log2(
                want.abs().clamp_min(2.0 ** -126))) - 7)
        assert bool(((got.float() - want).abs() <= tol).all())


FLASH_CARD = [(2, s, h, k, d, None) for s, h, k, d in FLASH_SWEEP] + [
    (1, 256, 2, 2, 64, 100), (2, 100, 4, 2, 32, 30), (1, 300, 4, 1, 256, 70),
    (2, 7, 3, 1, 128, None)] + [
    # one row past a 64-row tile; H / K of 1, 3 and 10; windows that are
    # no multiple of the tile, so KV tiles straddle the diagonal and the
    # window's edge at once; every head_dim
    (2, 65, 3, 1, 32, 40), (1, 65, 10, 10, 64, None),
    (1, 65, 10, 1, 128, 33), (2, 65, 3, 3, 256, None),
    (1, 4097, 10, 1, 256, 2048), (1, 4097, 3, 1, 128, 100),
    (1, 4097, 10, 10, 64, 1000), (1, 4097, 3, 3, 32, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,k,d,window", FLASH_CARD,
                         ids=[f"s{c[1]}h{c[2]}k{c[3]}d{c[4]}w{c[5]}"
                              for c in FLASH_CARD])
def test_flash_kernel_on_card(cuda, b, s, h, k, d, window, dtype):
    """The kernel against its plain version: fp32 at 2e-5 of the float32
    plain result; bf16 against the float64 plain result of the same bf16
    inputs, within one bf16 ulp of it plus the worst-case error of a
    float32 sum over the row's keys (`_flash_f64_bound`).  A float32
    oracle is no reference for bf16 outputs where the sum cancels: its
    own error there exceeds a bf16 ulp of the result."""
    targs, _ = _flash_inputs(23, b, s, h, k, d, dtype)
    targs = [t.to(cuda) for t in targs]
    n = ops.launch_counts()["flash_attention"]
    y = ops.flash_attention(*targs, window=window)
    assert ops.launch_counts()["flash_attention"] == n + 1
    want32 = ref.flash_attention_ref(*(t.float() for t in targs),
                                     window=window)
    if dtype == "float32":
        torch.testing.assert_close(y, want32, rtol=2e-5, atol=2e-5)
        return
    want64, cond, bound = _flash_f64_bound(targs, window)
    err64 = (y.double() - want64).abs()
    # the outputs the float32 oracle's 1-ulp check rejects, as evidence
    ulp32 = torch.exp2(torch.floor(torch.log2(
        want32.abs().clamp_min(2.0 ** -126))) - 7)
    off = ((y.float() - want32).abs() > ulp32).nonzero().tolist()
    for i in off[:8]:
        i = tuple(i)
        print(f"flash bf16 s{s}h{h}k{k}d{d}w{window} at {i}: kernel "
              f"{y[i].item():.9g}, float32 plain {want32[i].item():.9g}, "
              f"float64 plain {want64[i].item():.9g}, sum|p||v|/l "
              f"{cond[i].item():.4g}, |kernel - float64| "
              f"{err64[i].item():.3g} <= bound {bound[i].item():.3g}: "
              f"{bool(err64[i] <= bound[i])}")
    print(f"flash bf16 s{s}h{h}k{k}d{d}w{window}: {len(off)} outputs beyond "
          f"1 ulp of the float32 oracle; {int((err64 > bound).sum())} "
          f"beyond the float64 bound")
    assert bool((err64 <= bound).all())


# MLA's prefill attends with q/k wider than v: DeepSeek-V2's (192, 128)
# and the reduced model's (64, 32) on the card, causal and windowed
FLASH_DV_CARD = [(1, 200, 8, 8, 192, 128, None), (2, 65, 4, 4, 64, 32, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,k,dqk,dv,window", FLASH_DV_CARD,
                         ids=[f"dqk{c[4]}dv{c[5]}" for c in FLASH_DV_CARD])
def test_flash_kernel_on_card_with_a_narrower_value_head(cuda, b, s, h, k,
                                                         dqk, dv, window,
                                                         dtype):
    """q/k of DQK and v of DV: the output (B, S, H, DV) held as
    `test_flash_kernel_on_card` holds it, at the default scale
    1/sqrt(DQK)."""
    rng = np.random.default_rng(25)
    targs = [_pair(rng.standard_normal((b, s, n, d)).astype(np.float32),
                   dtype)[0].to(cuda)
             for n, d in ((h, dqk), (k, dqk), (k, dv))]
    n = ops.launch_counts()["flash_attention"]
    y = ops.flash_attention(*targs, window=window)
    assert ops.launch_counts()["flash_attention"] == n + 1
    assert tuple(y.shape) == (b, s, h, dv) and y.dtype == targs[0].dtype
    if dtype == "float32":
        torch.testing.assert_close(
            y, ref.flash_attention_ref(*targs, window=window), rtol=2e-5,
            atol=2e-5)
        return
    want64, _, bound = _flash_f64_bound(targs, window)
    assert bool(((y.double() - want64).abs() <= bound).all())


# the training path's gradient through rows 5-7: a grad-requiring input
# on the card, at shapes that keep the training layout (x, B and C as
# views into one projection, as Mamba2 hands them over)
GRAD_CARD = ["rmsnorm", "flash", "flash_window", "ssd_zero", "ssd_carried"]
# the SSD case: batch, seq, heads, groups, head dim, state; the projection
# holds 4 other columns, then x (H*P), B and C (G*N each)
GRAD_SSD = (2, 128, 4, 1, 32, 16)


def _grad_card_inputs(case, cuda):
    """The case's leaves and keywords.  The SSD's leaves are (proj, dt, A
    [, initial state]): x, B and C are sliced from the grad-requiring
    projection by `_grad_card_call`, so the kernel and the plain backward
    see the strided views."""
    gen = torch.Generator(device=cuda).manual_seed(31)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)
    if case == "rmsnorm":
        return [randn(2, 100, 768), 1 + 0.1 * randn(768)], {}
    if case.startswith("flash"):
        return ([randn(2, 130, 6, 64), randn(2, 130, 2, 64),
                 randn(2, 130, 2, 64)],
                {"window": 33 if case == "flash_window" else None})
    b, s, h, g, p, n = GRAD_SSD
    proj = torch.cat([randn(b, s, 4 + h * p), 0.3 * randn(b, s, 2 * g * n)],
                     dim=-1)
    dt = torch.nn.functional.softplus(randn(b, s, h))
    A = -torch.linspace(1.0, 16.0, h, device=cuda)
    init = [randn(b, h, p, n)] if case == "ssd_carried" else []
    return [proj, dt, A] + init, {"chunk": 64, "return_state": True}


def _grad_card_call(case, fn, leaves, kw):
    if not case.startswith("ssd"):
        return fn(*leaves, **kw)
    _, _, h, g, p, n = GRAD_SSD
    proj, dt, A = leaves[:3]
    x = proj[..., 4:4 + h * p].unflatten(-1, (h, p))
    Bm = proj[..., 4 + h * p:4 + h * p + g * n].unflatten(-1, (g, n))
    Cm = proj[..., 4 + h * p + g * n:].unflatten(-1, (g, n))
    return fn(x, dt, A, Bm, Cm, initial_state=(leaves[3] if len(leaves) > 3
                                               else None), **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("case", GRAD_CARD)
def test_kernel_gradient_on_card(cuda, case):
    """Every input requires grad: the wrapper launches its kernel once
    (the counter moves) and returns outputs with a grad_fn; the backward
    launches nothing, and its gradients equal the plain version's autograd
    on the card at rtol = 1e-5, atol = 1e-6 x the largest gradient (the
    backward recomputes that plain version on the same inputs, so only a
    library's choice of summation order could part them).  The forward
    is held to its plain version: rmsnorm at 1e-5, flash at 2e-5 and the
    SSD within 1e-3 x rms + 1e-4 x |v| (chip_smoke.py's rule: at chunks
    other than the kernel's 64-row tile the decays round differently)."""
    from repro_torch.kernels.ssd_scan import ssd_chunked_plain

    ins, kw = _grad_card_inputs(case, cuda)
    fn, plain, name, fwd_tol = {
        "rmsnorm": (ops.rmsnorm, ref.rmsnorm_ref, "rmsnorm", 1e-5),
        "flash": (ops.flash_attention, ref.flash_attention_ref,
                  "flash_attention", 2e-5),
        "ssd": (ops.ssd_scan, ssd_chunked_plain, "ssd_scan", None),
    }[case.split("_")[0]]
    leaves = [t.detach().clone().requires_grad_() for t in ins]
    plain_leaves = [t.detach().clone().requires_grad_() for t in ins]
    before = ops.launch_counts()
    out = _grad_card_call(case, fn, leaves, kw)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == name) for k in after}
    out = out if isinstance(out, tuple) else (out,)
    want = _grad_card_call(case, plain, plain_leaves, kw)
    want = want if isinstance(want, tuple) else (want,)
    assert all(o.grad_fn is not None for o in out)
    for o, w in zip(out, want):
        if name == "ssd_scan":
            tol = 1e-3 * w.square().mean().sqrt() + 1e-4 * w.abs()
            assert bool(((o - w).abs() <= tol).all())
        else:
            torch.testing.assert_close(o, w, rtol=fwd_tol, atol=fwd_tol)
    cts = [torch.randn(w.shape, generator=torch.Generator(
        device=cuda).manual_seed(32 + i), device=cuda)
        for i, w in enumerate(want)]
    sum((o * c).sum() for o, c in zip(out, cts)).backward()
    sum((w * c).sum() for w, c in zip(want, cts)).backward()
    assert ops.launch_counts() == after
    got = [t.grad for t in leaves]
    exp = [t.grad for t in plain_leaves]
    for g, e in zip(got, exp):
        torch.testing.assert_close(g, e, rtol=1e-5,
                                   atol=1e-6 * e.abs().max().item())
