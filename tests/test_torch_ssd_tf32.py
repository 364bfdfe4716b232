"""Why the SSD kernel takes three tensor-core products, on the CPU.

``ssd_chunk`` runs both of its products (S = cm.bm^T and (S o L).xdt)
on the tensor cores from TF32 operands.  ``ssd_intra_tf32`` emulates
that: with ``passes=3`` (3xTF32, the kernel's route: each operand split
as hi + lo, both TF32, and lo.hi + hi.lo + hi.hi summed in float32) it
must stay within the kernel's float32 contract, ``ssd_err <= 1`` under
``SSD_TOL = 1e-4`` of each (chunk, head) block's RMS, against the JAX
package's Pallas kernel (interpret mode, full float32 on the CPU); with
``passes=1`` (single-pass TF32) it must not, which records why the
kernel pays for three products.

Inputs are drawn with NumPy from a seed, in the two draws of
``tests/test_torch_ssd.py``: "kernels" keeps decays far above exp(-60)
over a chunk, "model" takes the model's range of A, past the clip.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk.ssd_chunk import ssd_intra_pallas
from repro_torch.kernels.ssd_chunk import ref

torch.set_num_threads(1)

# (BC, C, N, H, P): the mamba2 chunk and state at 4 chunks and 8 heads,
# and a small shape
SHAPES = [(4, 128, 128, 8, 64), (3, 32, 16, 5, 32)]


def _inputs(BC, C, N, H, P, kind, seed=11):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    cm, bm = f(BC, C, N) * 0.3, f(BC, C, N) * 0.3
    xdt = f(BC, H, C, P) * 0.25
    if kind == "kernels":
        la = -np.logaddexp(f(BC, H, C), 0.0) * 0.5 * np.exp(
            f(H) * 0.3)[None, :, None]
    else:
        la = -np.logaddexp(f(BC, H, C) + 1.0, 0.0) * np.linspace(
            1.0, 16.0, H)[None, :, None]
    cum = np.cumsum(la, axis=-1).astype(np.float32)
    return [np.asarray(a, np.float32) for a in (cm, bm, xdt, cum)]


@pytest.fixture(scope="module")
def pallas_cache():
    return {}


def _pallas(arrs, key, cache):
    if key not in cache:
        cache[key] = torch.as_tensor(np.array(ssd_intra_pallas(
            *[jnp.asarray(a) for a in arrs], interpret=True)))
    return cache[key]


@pytest.mark.parametrize("kind", ["kernels", "model"])
@pytest.mark.parametrize("BC,C,N,H,P", SHAPES)
def test_3xtf32_meets_the_float32_contract(BC, C, N, H, P, kind,
                                           pallas_cache):
    arrs = _inputs(BC, C, N, H, P, kind)
    want = _pallas(arrs, (BC, C, N, H, P, kind), pallas_cache)
    got = ref.ssd_intra_tf32(*[torch.as_tensor(a) for a in arrs], passes=3)
    assert got.shape == want.shape and got.dtype == torch.float32
    _, over = ref.ssd_err(got, want)
    assert over <= 1.0


@pytest.mark.parametrize("kind", ["kernels", "model"])
@pytest.mark.parametrize("BC,C,N,H,P", SHAPES)
def test_single_pass_tf32_misses_it(BC, C, N, H, P, kind, pallas_cache):
    arrs = _inputs(BC, C, N, H, P, kind)
    want = _pallas(arrs, (BC, C, N, H, P, kind), pallas_cache)
    got = ref.ssd_intra_tf32(*[torch.as_tensor(a) for a in arrs], passes=1)
    _, over = ref.ssd_err(got, want)
    assert over > 1.0


def test_tf32_round_keeps_ten_mantissa_bits_ties_to_even():
    one = 1.0
    ulp = 2.0 ** -10                    # TF32's spacing in [1, 2)
    x = torch.tensor([one, one + ulp / 2, one + 3 * ulp / 2,
                      one + ulp / 2 + 2.0 ** -20, -(one + ulp / 2), 3.0,
                      0.0, 2.0 ** -126])
    want = torch.tensor([one, one, one + 2 * ulp, one + ulp, -one, 3.0,
                         0.0, 2.0 ** -126])
    got = ref.tf32_round(x)
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()


def test_hi_lo_split_is_exact_to_22_bits():
    """x - (hi + lo) is below 2**-21 of |x|: what 3xTF32 keeps of each
    float32 operand."""
    x = torch.as_tensor(np.random.default_rng(12).standard_normal(
        4096).astype(np.float32))
    hi = ref.tf32_round(x)
    lo = ref.tf32_round(x - hi)
    rel = ((x.double() - hi.double() - lo.double()).abs()
           / x.double().abs()).max().item()
    assert rel < 2.0 ** -21


def test_tf32_emulation_rejects_other_pass_counts():
    arrs = [torch.as_tensor(a) for a in _inputs(1, 16, 8, 1, 16, "kernels")]
    with pytest.raises(ValueError, match="passes"):
        ref.ssd_intra_tf32(*arrs, passes=2)
