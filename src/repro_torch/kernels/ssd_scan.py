"""The Mamba2 SSD scan: the CUDA kernel and its plain version.

`ssd_scan(x, dt, A, Bm, Cm, chunk=..., initial_state=None,
return_state=False)` computes, per batch row and head h (state group
h // (H/G)), the recurrence

    S_t = exp(dt_t A_h) S_{t-1} + (x_t dt_t) B_t^T,    y_t = S_t C_t

over x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N), with the state
(B,H,P,N) in float32 and y in x's type.  The kernel takes dt and A in
float32, as the model makes them, so x dt is a float32 product.  It replaces
`repro/kernels/ssd_scan.py`'s `ssd_scan_pallas` (source in
`csrc/ssd_scan.cu`) and adds what `mamba2_prefill` needs of
`nn/ssm.py:ssd_chunked`: an initial state in and the final state out.

A CUDA tensor launches the kernel (or raises); a CPU or meta tensor takes
the plain version, `ssd_chunked_plain`, the reference's chunked dual form
at the caller's `chunk`.  The kernel cuts the sequence into its own
64-row tiles whatever `chunk` is (the result does not depend on the
chunk length, up to rounding), but `S % chunk == 0` is required on
every device, as the reference asserts.  One call runs the kernel's two
passes (the chain of states across tiles, then the tiles' outputs) over a
float32 scratch the wrapper allocates; `launches` counts calls of the
kernel.

Training: on a CUDA tensor with grad enabled and an input that requires
grad, the call goes through `_SSDFn`, whose forward launches the same
kernel and whose backward is the designated gradient: it recomputes
`ssd_chunked_plain` at the caller's chunk on the saved inputs (x, B and C
are views into one projection, as the forward got them) and
differentiates it with respect to x, dt, A, B, C and the initial state.
The reference has no backward kernel either (its Mamba2 trains through
the plain chunked form), so the forward always runs on the kernel and the
backward launches nothing.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

launches = {"ssd_scan": 0}

MAX_STATE = 256                     # kMaxN in csrc/ssd_scan.cu
TILE = 64                           # kQ in csrc/ssd_scan.cu
_SIGNATURES = {
    "ssd_scan_launch": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 8 + [ctypes.c_int, ctypes.c_void_p],
}
_TYPES = (torch.float32, torch.bfloat16)


def ssd_chunked_plain(x, dt, A, Bm, Cm, *, chunk: int, initial_state=None,
                      return_state: bool = False):
    """The reference's chunked SSD (`repro/nn/ssm.py:ssd_chunked`) in
    plain torch: the intra-chunk quadratic term, masked before the
    exponential, plus the inter-chunk recurrence over chunk states."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    assert S % chunk == 0, f"seq {S} % chunk {chunk} != 0"
    nc = S // chunk
    rep = H // G

    dA = dt * A[None, None, :]                           # (B,S,H)
    xd = x * dt[..., None]                               # dt-scaled input

    def ck(t):
        return t.reshape(t.shape[0], nc, chunk, *t.shape[2:])
    xc, dAc, Bc, Cc = ck(xd), ck(dA), ck(Bm), ck(Cm)

    cum = torch.cumsum(dAc, dim=2)                       # (B,nc,Q,H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qt,Qs,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    # mask BEFORE exp: the masked entries are large and positive
    seg = seg.masked_fill(~mask[None, None, :, :, None], -1e30)
    decay = torch.exp(seg)
    CB = torch.einsum("bcqgs,bckgs->bcqkg", Cc.float(), Bc.float())
    CB = CB.repeat_interleave(rep, dim=-1)               # (B,nc,Qt,Qs,H)
    y_intra = torch.einsum("bcqkh,bcqkh,bckhp->bcqhp", CB, decay, xc.float())

    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)    # (B,nc,Q,H)
    Bh = Bc.repeat_interleave(rep, dim=3)                # (B,nc,Q,H,N)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_to_end,
                          Bh.float(), xc.float())
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (B,nc,H)

    if initial_state is None:
        carry = torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                            device=x.device)
    else:
        carry = initial_state.float()
    prev = []
    for c in range(nc):                                  # state BEFORE chunk c
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (B,nc,H,P,N)

    Ch = Cc.repeat_interleave(rep, dim=3)                # (B,nc,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch.float(),
                           prev_states, torch.exp(cum))
    y = (y_intra + y_inter).reshape(Bsz, S, H, P).to(x.dtype)
    if return_state:
        return y, carry
    return y


def _token_strides(t: torch.Tensor, inner: tuple, what: str) -> tuple:
    """(batch stride, sequence stride) of a (B, S, *inner) tensor whose
    inner axes are dense; the model's x/B/C are views into one projection
    and keep the projection's row stride."""
    step, dense = 1, True
    for size, stride in zip(reversed(inner), reversed(t.stride()[2:])):
        dense &= size == 1 or stride == step       # a size-1 axis has no step
        step *= size
    if not dense and t.numel():
        raise ValueError(f"ssd_scan: {what} {tuple(t.shape)} with strides "
                         f"{t.stride()} is not dense past the sequence axis")
    return t.stride(0), t.stride(1)


def ssd_scan(x, dt, A, Bm, Cm, *, chunk: int, initial_state=None,
             return_state: bool = False):
    """y (B,S,H,P) in x's type, and the final (B,H,P,N) float32 state if
    `return_state`."""
    if x.device.type in ("cpu", "meta"):
        return ssd_chunked_plain(x, dt, A, Bm, Cm, chunk=chunk,
                                 initial_state=initial_state,
                                 return_state=return_state)
    ins = (x, dt, A, Bm, Cm, initial_state)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ins):
        return _SSDFn.apply(*ins, chunk, return_state)
    return _launch(*ins, chunk, return_state)


class _SSDFn(torch.autograd.Function):
    """The kernel forward; the backward differentiates the plain chunked
    form recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, initial_state, chunk, return_state):
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        ctx.kw = dict(chunk=chunk, return_state=return_state)
        return _launch(x, dt, A, Bm, Cm, initial_state, chunk, return_state)

    @staticmethod
    def backward(ctx, *g):
        grads = ref.plain_grads(
            lambda x, dt, A, Bm, Cm, init: ssd_chunked_plain(
                x, dt, A, Bm, Cm, initial_state=init, **ctx.kw),
            ctx.saved_tensors, ctx.needs_input_grad[:6], *g)
        return (*grads, None, None)


def _launch(x, dt, A, Bm, Cm, initial_state, chunk: int,
            return_state: bool):
    if x.device.type != "cuda":
        raise ValueError(f"no ssd_scan kernel for device {x.device}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"ssd_scan: seq {S} % chunk {chunk} != 0")
    if x.dtype not in _TYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, B and C must share one type, float32 "
                        f"or bfloat16; got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and A must be float32; got "
                        f"{dt.dtype} and {A.dtype}")
    if (tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != tuple(Cm.shape)
            or tuple(Bm.shape[:2]) != (Bsz, S) or H % G):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)} do not fit")
    if N > MAX_STATE:
        raise ValueError(f"ssd_scan: state size {N} > {MAX_STATE}")
    if any(t.device != x.device for t in (dt, A, Bm, Cm)):
        raise ValueError("ssd_scan: inputs on different devices")
    xb, xs = _token_strides(x, (H, P), "x")
    bb, bs = _token_strides(Bm, (G, N), "B")
    cb, cs = _token_strides(Cm, (G, N), "C")
    db, ds = _token_strides(dt, (H,), "dt")
    A = A.contiguous()
    init = None
    if initial_state is not None:
        if tuple(initial_state.shape) != (Bsz, H, P, N):
            raise ValueError(f"ssd_scan: initial state "
                             f"{tuple(initial_state.shape)} != "
                             f"{(Bsz, H, P, N)}")
        init = initial_state.float().contiguous()
    if x.numel() == 0:
        raise ValueError(f"ssd_scan: empty input {tuple(x.shape)}")
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    final = (torch.empty((Bsz, H, P, N), dtype=torch.float32,
                         device=x.device) if return_state else None)
    # each tile's carried-in state, transposed: (B, tiles, H, N, P
    # rounded up to 4), written by the kernel's chain and read by its
    # output pass
    tiles = -(-S // TILE)
    scratch = torch.empty(Bsz * tiles * H * N * (-(-P // 4) * 4),
                          dtype=torch.float32, device=x.device)
    lib = build.load("ssd_scan", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if init is None else init.data_ptr(),
            y.data_ptr(), None if final is None else final.data_ptr(),
            scratch.data_ptr(), Bsz, S, H, P, G, N, xb, xs, bb, bs, cb, cs,
            db, ds,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssd_scan")
    launches["ssd_scan"] += 1
    if return_state:
        return y, final
    return y
