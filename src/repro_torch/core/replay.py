"""Experience replay (paper Fig. 2.11): a device-resident ring buffer.

The buffer is a dict of tensors on one device plus the ring bookkeeping
``ptr``/``size`` as host ints (the JAX package keeps them as device
scalars; here the host knows them without a sync):

- :func:`replay_init`    allocate an empty buffer;
- :func:`replay_add`     write N transitions at ``(ptr + arange(N)) %
  capacity`` (ring semantics, N <= capacity), **in place**: where the
  JAX package donates the buffer to its jitted scatter, the port writes
  into the same tensors, and the caller keeps using the dict it passed;
- :func:`replay_sample`  gather a batch at uniform indices drawn from a
  ``torch.Generator``, or at indices passed in (how the tests and a
  training round's pre-drawn sample indices feed it).

``s2`` is the residual-RQ-only encoding written by the environment
(Sec. 4.2); sequences have the fixed padded length T = 1 primer +
max_rq sub-jobs.

:class:`DeviceReplay` is a thin stateful wrapper over the functional
ops; :class:`ReplayBuffer` is a copy of the JAX package's host-side
NumPy ring (shared ground truth for the ring semantics).
"""
from __future__ import annotations

import numpy as np
import torch

_FIELDS = ("s", "mask", "a", "r", "s2", "mask2")


def replay_fields(buf: dict) -> tuple[str, ...]:
    """Stored per-transition fields: everything except ``ptr``/``size``."""
    return tuple(k for k in buf if k not in ("ptr", "size"))


def replay_init(capacity: int, seq_len: int, feat_dim: int, act_dim: int,
                device: str | torch.device = "cuda") -> dict:
    T, F, G = seq_len, feat_dim, act_dim
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=device)
    return dict(s=z(capacity, T, F), mask=z(capacity, T, dt=torch.bool),
                a=z(capacity, T - 1, G), r=z(capacity),
                s2=z(capacity, T, F), mask2=z(capacity, T, dt=torch.bool),
                ptr=0, size=0)


def replay_add(buf: dict, batch: dict) -> dict:
    """Ring-write a stacked batch of transitions (leading axis N) into
    ``buf`` in place; returns ``buf``.  N must not exceed the capacity
    (one write cannot wrap the ring more than once)."""
    cap = buf["r"].shape[0]
    n = batch["r"].shape[0]
    if n > cap:
        raise ValueError(f"replay_add: {n} transitions exceed the capacity "
                         f"{cap}")
    idx = (buf["ptr"] + torch.arange(n, device=buf["r"].device)) % cap
    for k in replay_fields(buf):
        buf[k][idx] = batch[k].to(buf[k].dtype)
    buf["ptr"] = (buf["ptr"] + n) % cap
    buf["size"] = min(buf["size"] + n, cap)
    return buf


def sample_indices(buf: dict, batch_size: int,
                   gen: torch.Generator) -> torch.Tensor:
    """Uniform indices in ``[0, max(size, 1))`` from ``gen`` (on the
    generator's device)."""
    return torch.randint(0, max(buf["size"], 1), (batch_size,),
                         generator=gen, device=gen.device)


def replay_sample(buf: dict, batch_size: int | None = None,
                  gen: torch.Generator | None = None, idx=None) -> dict:
    """A batch of stored transitions at ``idx`` (passed in), or at
    ``batch_size`` uniform indices drawn from ``gen``."""
    if idx is None:
        idx = sample_indices(buf, batch_size, gen)
    idx = torch.as_tensor(idx, device=buf["r"].device)
    return {k: buf[k][idx] for k in replay_fields(buf)}


class DeviceReplay:
    """Stateful convenience wrapper over the functional device buffer."""

    def __init__(self, capacity: int, seq_len: int, feat_dim: int,
                 act_dim: int, device: str | torch.device = "cuda"):
        self.capacity = capacity
        self.data = replay_init(capacity, seq_len, feat_dim, act_dim,
                                device)

    def add_batch(self, batch: dict) -> None:
        """batch: transitions stacked over a leading axis; extra leading
        axes (e.g. (episodes, periods, ...)) are flattened first."""
        extra = batch["r"].dim() - 1
        if extra:
            batch = {k: v.reshape((-1,) + tuple(v.shape[1 + extra:]))
                     for k, v in batch.items() if k in _FIELDS}
        replay_add(self.data, batch)

    def sample(self, batch_size: int, gen: torch.Generator) -> dict:
        return replay_sample(self.data, batch_size, gen)

    def __len__(self) -> int:
        return self.data["size"]


class ReplayBuffer:
    """Host-side NumPy ring buffer (a copy of the JAX package's)."""

    def __init__(self, capacity: int, seq_len: int, feat_dim: int,
                 act_dim: int, seed: int = 0):
        self.capacity = capacity
        T, F, G = seq_len, feat_dim, act_dim
        self.s = np.zeros((capacity, T, F), np.float32)
        self.mask = np.zeros((capacity, T), bool)
        self.a = np.zeros((capacity, T - 1, G), np.float32)
        self.r = np.zeros((capacity,), np.float32)
        self.s2 = np.zeros((capacity, T, F), np.float32)
        self.mask2 = np.zeros((capacity, T), bool)
        self.size = 0
        self.ptr = 0
        self.rng = np.random.default_rng(seed)

    def add(self, s, mask, a, r, s2, mask2):
        i = self.ptr
        self.s[i], self.mask[i], self.a[i] = s, mask, a
        self.r[i], self.s2[i], self.mask2[i] = r, s2, mask2
        self.ptr = (self.ptr + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)

    def add_batch(self, s, mask, a, r, s2, mask2):
        for i in range(len(r)):
            self.add(s[i], mask[i], a[i], r[i], s2[i], mask2[i])

    def sample(self, batch_size: int) -> dict[str, np.ndarray]:
        idx = self.rng.integers(0, self.size, size=batch_size)
        return dict(s=self.s[idx], mask=self.mask[idx], a=self.a[idx],
                    r=self.r[idx], s2=self.s2[idx], mask2=self.mask2[idx])

    def __len__(self) -> int:
        return self.size
