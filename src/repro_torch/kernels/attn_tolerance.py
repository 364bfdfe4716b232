"""How closely an attention kernel's output must match its plain version.

An attention output row is a softmax-weighted mean of V rows, so its
size falls as 1/sqrt(n) with the n keys it sees: a fixed absolute
tolerance that suits a row of a few keys is larger than a whole row of
thousands.  Each element is held instead to

    |got - want| <= rtol * |want| + row * rms(want's row over D)

- ``rtol``: in bfloat16, one ulp (2**-7 of |want| at most): both
  outputs are rounded once from float32 values that differ by far less;
- ``row``: what the float32 arithmetic may differ by, scaled to the
  row.  In bfloat16 it is 1.5e-2: one side of each comparison rounds p
  to bf16 before P.V (relative error up to 2**-9 per weight, about
  1.1e-3 of the row's RMS per element, 5e-3 at the tail of a large
  call) where the other keeps it in float32: the plain decode rounds
  it and the decode kernel does not; the prefill kernel (tensor-core
  P.V) rounds it and ``attention_chunked`` does not.  In float32 both
  terms are 1e-4 (sums in another order over up to 32768 keys).

A kernel that drops one key of a short row, or an 8-key chunk of a
2112-key row, moves some element by several times this bound
(``tests/test_torch_attention.py`` shows it on the plain versions).
"""
from __future__ import annotations

import torch

# dtype -> (rtol, row)
ATTN_TOL = {torch.float32: (1e-4, 1e-4),
            torch.bfloat16: (2.0 ** -7, 1.5e-2)}


def attn_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| over its bound): the
    outputs match when the second is at most 1."""
    rtol, row = ATTN_TOL[want.dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rms = w.pow(2).mean(dim=-1, keepdim=True).sqrt()
    bound = (rtol * w.abs() + row * rms).clamp_min(torch.finfo(
        torch.float32).tiny)
    return diff.max().item(), (diff / bound).max().item()
