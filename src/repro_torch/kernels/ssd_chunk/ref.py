"""Plain PyTorch versions of the Mamba-2 SSD (state-space duality)
scan, copies of ``repro.kernels.ssd_chunk.ref`` plus the plain version
of the intra-chunk kernel.

- ``ssd_scan_ref``: the exact sequential state recurrence (ground
  truth);
- ``ssd_chunked_ref``: the chunked SSD of the reference, written with
  einsums (small-shape oracle; T must be a multiple of the chunk);
- ``ssd_decode_step``: one token of the recurrence, the decode path;
- ``ssd_intra_ref``: exactly what the intra-chunk kernel computes over
  its grid (``_ssd_kernel`` of the TPU kernel): the CPU path of
  ``ops.ssd_intra`` and the kernel's oracle on the card;
- ``ssd_intra_vjp``: the gradient of ``ssd_intra_ref`` (the backward
  of ``ops.SSDIntra`` on either device);
- ``ssd_err``: how closely the kernel must match ``ssd_intra_ref``;
- ``ssd_intra_tf32``: ``ssd_intra_ref`` with both products taken as the
  tensor cores take them, in single-pass TF32 or in 3xTF32 (the
  kernel's route), each operand rounded by ``tf32_round``.  A test
  oracle of the precision, on no main path.

Shapes: x (B,T,H,P), dt (B,T,H) [positive], A (H,) [negative],
Bm/Cm (B,T,N) shared across heads (G=1).  The scans return
(y (B,T,H,P), final_state (B,H,N,P)).  Arithmetic is float32.
"""
from __future__ import annotations

import torch

CLIP = 60.0          # decays are clipped to exp(-60) before the exp


def ssd_scan_ref(x, dt, A, Bm, Cm, init_state=None):
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    a = torch.exp(dt * A[None, None, :])                  # (B,T,H)
    xdt = x * dt[..., None]                               # (B,T,H,P)
    S = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state)
    ys = []
    for t in range(T):
        S = S * a[:, t, :, None, None] + torch.einsum(
            "bn,bhp->bhnp", Bm[:, t], xdt[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], S))
    return torch.stack(ys, dim=1), S


def ssd_chunked_ref(x, dt, A, Bm, Cm, init_state=None, *, chunk: int = 128):
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    assert T % chunk == 0, "ops.ssd_forward pads T to the chunk size"
    nc = T // chunk
    la = (dt * A[None, None, :]).reshape(B, nc, chunk, H)  # log-decay
    cum = torch.cumsum(la, dim=2)                           # inclusive
    xdt = (x * dt[..., None]).reshape(B, nc, chunk, H, P)
    Bc = Bm.reshape(B, nc, chunk, N)
    Cc = Cm.reshape(B, nc, chunk, N)

    # ---- intra-chunk (the kernel computes exactly this) ----
    s = torch.einsum("bkin,bkjn->bkij", Cc, Bc)             # (B,nc,C,C)
    ar = torch.arange(chunk, device=x.device)
    causal = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    diff = torch.clamp(cum[:, :, :, None, :] - cum[:, :, None, :, :],
                       -CLIP, 0.0)
    L = torch.where(causal, torch.exp(diff), 0.0)
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", s[..., None] * L, xdt)

    # ---- inter-chunk state recurrence ----
    decay_out = torch.exp(torch.clamp(cum[:, :, -1:, :] - cum, -CLIP, 0.0))
    chunk_state = torch.einsum("bkjn,bkjhp->bkhnp", Bc,
                               decay_out[..., None] * xdt)
    total = torch.exp(torch.clamp(cum[:, :, -1, :], min=-CLIP))  # (B,nc,H)
    S = (torch.zeros((B, H, N, P), dtype=x.dtype, device=x.device)
         if init_state is None else init_state)
    s_in = []
    for k in range(nc):                         # emit the state *into* k
        s_in.append(S)
        S = S * total[:, k, :, None, None] + chunk_state[:, k]
    Sin = torch.stack(s_in, dim=1)                          # (B,nc,H,N,P)
    decay_in = torch.exp(torch.clamp(cum, min=-CLIP))       # (B,nc,C,H)
    y_inter = torch.einsum("bkin,bkhnp->bkihp", Cc, Sin) \
        * decay_in[..., None]
    y = (y_intra + y_inter).reshape(B, T, H, P)
    return y, S


def ssd_decode_step(state, x_t, dt_t, A, b_t, c_t):
    """One token of the recurrence.  state (B,H,N,P), x_t (B,H,P),
    dt_t (B,H), b_t/c_t (B,N) -> (new_state, y_t (B,H,P))."""
    a_t = torch.exp(dt_t * A[None, :])
    state = state * a_t[:, :, None, None] + torch.einsum(
        "bn,bhp->bhnp", b_t, x_t * dt_t[..., None])
    y = torch.einsum("bn,bhnp->bhp", c_t, state)
    return state, y


def ssd_intra_ref(cm, bm, xdt, cum):
    """cm/bm (BC,C,N), xdt (BC,H,C,P), cum (BC,H,C) -> y (BC,H,C,P).

    Per (batch*chunk, head): ``S = cm @ bm^T``,
    ``L = tril(exp(clip(cum_i - cum_j, -60, 0)))``, ``y = (S*L) @ xdt``,
    in float32.
    """
    C = cm.shape[1]
    s = torch.bmm(cm.float(), bm.float().transpose(1, 2))   # (BC,C,C)
    cum = cum.float()
    ar = torch.arange(C, device=cm.device)
    causal = ar[:, None] >= ar[None, :]
    diff = torch.clamp(cum[:, :, :, None] - cum[:, :, None, :], -CLIP, 0.0)
    L = torch.where(causal, torch.exp(diff), 0.0)           # (BC,H,C,C)
    return torch.matmul(s[:, None] * L, xdt.float())


# chunks (rows of BC) whose intra-chunk term the backward recomputes at
# once: BLOCK_BC, or more where a chunk's (H, C, C) float32 decay matrix
# is small, as long as the block's stays within BLOCK_BYTES (BLOCK_BC
# chunks at mamba2-2.7b's (80, 128, 128)); bounds the decay matrices
# held at a time
BLOCK_BC = 16
BLOCK_BYTES = BLOCK_BC * 80 * 128 * 128 * 4


def block_rows(H: int, C: int) -> int:
    """Chunks a block of :func:`ssd_intra_vjp` recomputes at once."""
    return max(BLOCK_BC, BLOCK_BYTES // max(1, H * C * C * 4))


def ssd_intra_vjp(cm, bm, xdt, cum, dy):
    """The gradient of :func:`ssd_intra_ref` at (cm, bm, xdt, cum)
    against ``dy`` (BC,H,C,P): (dcm, dbm, dxdt, dcum) in the inputs'
    dtypes, recomputed :func:`block_rows` chunks at a time under
    autograd."""
    grads = [torch.empty_like(x) for x in (cm, bm, xdt, cum)]
    rows = block_rows(xdt.shape[1], cm.shape[1])
    for lo in range(0, cm.shape[0], rows):
        part = [x[lo:lo + rows].detach().requires_grad_()
                for x in (cm, bm, xdt, cum)]
        with torch.enable_grad():
            y = ssd_intra_ref(*part)
            got = torch.autograd.grad(y, part, dy[lo:lo + rows])
        for g, x in zip(grads, got):
            g[lo:lo + rows] = x
    return tuple(grads)


# The kernel's tolerance against ssd_intra_ref: each element within
# SSD_TOL of the RMS of its (batch*chunk, head) block of y.  The two may
# sum float32 products in another order (over N for S, over up to C
# columns for y); the sums' rounding is ~1e-6 of the block's RMS at
# C = N = 128, so 1e-4 leaves a margin, while a wrong decay, a dropped
# column tile or a stray upper-triangle term moves elements by a
# sizeable fraction of the RMS.
SSD_TOL = 1e-4


def ssd_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| over its bound) for
    y (BC,H,C,P): they match when the second is at most 1."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rms = w.pow(2).mean(dim=(-2, -1), keepdim=True).sqrt()
    bound = (SSD_TOL * rms).clamp_min(torch.finfo(torch.float32).tiny)
    return diff.max().item(), (diff / bound).max().item()


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits): to
    nearest, ties to even, on the low 13 bits, which come out zero.
    (The kernel's ``cvt.rna`` sends ties away from zero instead; the
    two differ only on exact ties.)"""
    b = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    b = torch.where(b >= 2 ** 31, b - 2 ** 32, b)
    return b.to(torch.int32).view(torch.float32)


def _matmul_tf32(a, b, passes: int):
    """``a @ b`` in float32 from TF32 operands: one product of the
    rounded operands (``passes=1``), or with each split as hi + lo,
    lo.hi + hi.lo + hi.hi (``passes=3``)."""
    ah, bh = tf32_round(a), tf32_round(b)
    if passes == 1:
        return torch.matmul(ah, bh)
    al, bl = tf32_round(a - ah), tf32_round(b - bh)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def ssd_intra_tf32(cm, bm, xdt, cum, passes: int = 3):
    """``ssd_intra_ref`` with ``S = cm @ bm^T`` and ``(S*L) @ xdt`` both
    from TF32 operands, in ``passes`` 1 or 3 (module docstring)."""
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    C = cm.shape[1]
    s = _matmul_tf32(cm.float(), bm.float().transpose(1, 2), passes)
    cum = cum.float()
    ar = torch.arange(C, device=cm.device)
    causal = ar[:, None] >= ar[None, :]
    diff = torch.clamp(cum[:, :, :, None] - cum[:, :, None, :], -CLIP, 0.0)
    L = torch.where(causal, torch.exp(diff), 0.0)
    return _matmul_tf32(s[:, None] * L, xdt.float(), passes)
