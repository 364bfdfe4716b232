"""Device-resident telemetry primitives: counters, gauges, histograms.

The counterpart of the JAX package's ``telemetry/metrics.py`` on torch
tensors that live on an explicit device — the serving tick's queue
dict and the training round's metrics — and cross to the host only in
transfers those paths already make (the round's one metrics transfer,
the serving flush).  Nothing here may force a sync: every op is
shape-static and reads no value back to the host.  In particular no
``torch.bincount`` (on CUDA it reads the input's maximum back to size
its output), ``torch.histc`` or ``.item()``.

- **Counter**: a 0-d (or per-stream) integer; :func:`counter_add` is
  associative.
- **Gauge**: a 0-d float holding the *last* written value
  (:func:`gauge_set` — e.g. the replay ring's fill fraction).
- **Histogram**: fixed-bucket counts over a static edge vector
  (:func:`hist_init` / :func:`hist_add`).  Bucket ``i`` counts values
  in ``[edges[i-1], edges[i])`` with bucket ``0`` the underflow
  (``v < edges[0]``, ``-inf`` included) and bucket ``len(edges)`` the
  overflow (``v >= edges[-1]``, ``+inf`` and NaN included: where JAX's
  ``searchsorted`` puts NaN; a subnormal value counts as zero, as
  XLA's flush-to-zero arithmetic reads it).  Edges and values are
  float32, as in the reference (``SLA_EDGES``' 0.2 is not 0.2 in
  float64).  The add is a
  compare against the edges and a one-hot sum, not a scatter; counts
  may carry leading axes (one histogram per serving stream), the
  values then one row per histogram.  The quantile and mean estimates
  are host-side NumPy (:func:`hist_quantile`, :func:`hist_mean`),
  verbatim from the reference.

Bit-neutrality contract: these reducers only ever *read* the values
the surrounding program already computes and return new tensors;
enabling them changes no other output bit
(``tests/test_torch_telemetry_paths.py``).
"""
from __future__ import annotations

import numpy as np
import torch

# default edge vectors for the device aggregates the training round and
# the serving tick maintain (see repro_torch.core.train / core.serve)
SLA_EDGES = (0.2, 0.4, 0.6, 0.8, 0.9, 0.95, 0.99)
REWARD_EDGES = (-4.0, -2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 4.0)

I32 = torch.int32


# ---------------------------------------------------------------------------
# counters / gauges
# ---------------------------------------------------------------------------
def counter_init(dtype=I32, device="cpu", shape=()) -> torch.Tensor:
    """A zeroed counter (0-d, or ``shape`` for one per stream)."""
    return torch.zeros(shape, dtype=dtype, device=device)


def counter_add(c: torch.Tensor, n=1) -> torch.Tensor:
    """``c + n`` in the counter's dtype (associative).  ``n`` is a
    number or a tensor on the counter's device; a float truncates
    toward zero, as JAX's ``astype``."""
    if not torch.is_tensor(n):
        n = torch.as_tensor(n)          # a host scalar: no transfer
    return c + n.to(c.dtype)


def gauge_init(dtype=torch.float32, device="cpu") -> torch.Tensor:
    """A zeroed 0-d gauge."""
    return torch.zeros((), dtype=dtype, device=device)


def gauge_set(g: torch.Tensor, v) -> torch.Tensor:
    """The gauge overwritten with ``v`` (last write wins), in its dtype
    and on its device (a host value goes without a stream sync)."""
    return torch.as_tensor(v).to(g.dtype).to(g.device, non_blocking=True)


# ---------------------------------------------------------------------------
# fixed-bucket histograms
# ---------------------------------------------------------------------------
def hist_init(edges, device="cpu", shape=()) -> dict[str, torch.Tensor]:
    """Empty histogram over ``len(edges) + 1`` buckets.

    ``edges`` must be strictly increasing; the returned dict is
    ``dict(edges (E,) f32, counts shape + (E + 1,) i32)``.  The edges
    go to the device without a stream sync (``non_blocking``: a
    pageable source is staged before the call returns)."""
    e = np.asarray(edges, np.float32)
    if e.ndim != 1 or e.shape[0] < 1:
        raise ValueError(f"edges must be a non-empty 1-D vector, "
                         f"got shape {e.shape}")
    return dict(edges=torch.from_numpy(e).to(device, non_blocking=True),
                counts=torch.zeros(tuple(shape) + (e.shape[0] + 1,),
                                   dtype=I32, device=device))


def hist_bucket(edges: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bucket index of every float32 value: the number of edges ``<= v``
    (``searchsorted(edges, v, side="right")``), NaN in the overflow
    bucket.  A subnormal value counts as zero, as XLA's flush-to-zero
    comparison reads it in the reference."""
    v = torch.where(v.abs() < torch.finfo(torch.float32).tiny, 0.0, v)
    idx = (v[..., None] >= edges).sum(-1)
    return torch.where(torch.isnan(v), edges.shape[0], idx)


def hist_add(h: dict, values, weights=None) -> dict:
    """Fold a block of values into the histogram.

    ``values`` is flattened (per histogram, where the counts have
    leading axes); ``weights`` (optional, same size) are each cast to
    int32 (truncating toward zero, as the reference's ``sum(...,
    dtype=int32)``) and summed per bucket instead of unit counts.
    One-hot masked reduction — no scatter, no sync."""
    counts = h["counts"]
    lead = tuple(counts.shape[:-1])
    v = torch.as_tensor(values).to(device=counts.device,
                                   dtype=torch.float32).reshape(lead + (-1,))
    buckets = torch.arange(counts.shape[-1], device=counts.device)
    hot = hist_bucket(h["edges"], v)[..., None] == buckets  # (..., N, B)
    if weights is None:
        add = hot.sum(-2, dtype=counts.dtype)
    else:
        w = torch.as_tensor(weights).to(counts.device).reshape(lead + (-1,))
        add = torch.where(hot, w[..., None], 0).to(counts.dtype).sum(
            -2, dtype=counts.dtype)
    return dict(edges=h["edges"], counts=counts + add)


def hist_merge(a: dict, b: dict) -> dict:
    """Sum two histograms over identical edges (associative)."""
    return dict(edges=a["edges"], counts=a["counts"] + b["counts"])


def hist_quantile(h: dict, q: float) -> float:
    """Host-side quantile estimate by linear interpolation inside the
    bucket the ``q``-th mass falls in (numpy; call at chunk boundaries
    on transferred counts).  Underflow clamps to ``edges[0]``, overflow
    to ``edges[-1]``; an empty histogram returns ``nan``."""
    edges = np.asarray(h["edges"], np.float64)
    counts = np.asarray(h["counts"], np.float64)
    total = counts.sum()
    if total <= 0:
        return float("nan")
    # bucket i spans [lo[i], hi[i]) with the open ends pinned to the
    # extreme edges (we cannot estimate beyond the recorded range)
    lo = np.concatenate([[edges[0]], edges])
    hi = np.concatenate([edges, [edges[-1]]])
    cum = np.cumsum(counts)
    target = q * total
    i = int(np.searchsorted(cum, target, side="left"))
    i = min(i, len(counts) - 1)
    prev = cum[i - 1] if i > 0 else 0.0
    frac = (target - prev) / counts[i] if counts[i] > 0 else 0.0
    return float(lo[i] + frac * (hi[i] - lo[i]))


def hist_mean(h: dict) -> float:
    """Host-side bucket-midpoint mean estimate (nan when empty)."""
    edges = np.asarray(h["edges"], np.float64)
    counts = np.asarray(h["counts"], np.float64)
    total = counts.sum()
    if total <= 0:
        return float("nan")
    lo = np.concatenate([[edges[0]], edges])
    hi = np.concatenate([edges, [edges[-1]]])
    return float((counts * (lo + hi) / 2.0).sum() / total)


# ---------------------------------------------------------------------------
# the training round's aggregates
# ---------------------------------------------------------------------------
def round_telemetry(per_episode_sla, rewards, committed, replay_size,
                    replay_capacity: int) -> dict:
    """The round's telemetry block, on the device of ``per_episode_sla``
    (pure; rides the round's one metrics transfer — see
    ``repro_torch.core.train._round_body``).

    Returns flat ``tele_*`` leaves so the driver can serialize them
    without knowing histogram internals: SLA histogram counts over
    :data:`SLA_EDGES`, per-period reward histogram counts over
    :data:`REWARD_EDGES`, committed-sub-job counter, and the replay
    ring's fill fraction gauge (float32 size over float32 capacity, as
    the reference divides; ``replay_size`` may be a host int).
    """
    dev = per_episode_sla.device
    f32 = lambda x: (x.to(dev, torch.float32) if torch.is_tensor(x) else
                     torch.full((), float(x), dtype=torch.float32,
                                device=dev))
    sla_h = hist_add(hist_init(SLA_EDGES, dev), per_episode_sla)
    rew_h = hist_add(hist_init(REWARD_EDGES, dev), rewards)
    return dict(
        tele_sla_hist=sla_h["counts"],
        tele_reward_hist=rew_h["counts"],
        tele_committed=torch.as_tensor(committed).sum().to(I32),
        # tensor by tensor: a host-scalar divisor would be multiplied
        # by its reciprocal on the card, which can miss by an ulp
        tele_replay_fill=f32(replay_size) / f32(replay_capacity),
    )


# leaf names round_telemetry emits — consumers (the driver) iterate
# these instead of hard-coding
ROUND_TELE_COUNTS = ("tele_sla_hist", "tele_reward_hist", "tele_committed")
ROUND_TELE_GAUGES = ("tele_replay_fill",)
ROUND_TELE_KEYS = ROUND_TELE_COUNTS + ROUND_TELE_GAUGES
