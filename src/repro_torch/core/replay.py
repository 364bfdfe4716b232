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

For the rounds sharded over devices (``repro_torch.core.train``'s
``make_sharded_train_rounds``) each device holds a **double-buffered
pair** of rings (:func:`replay_pair_init` / :func:`replay_pair_step`): a
``read`` ring (every transition through round ``t - 1``, what round
``t``'s updates sample) and a ``write`` ring that takes round ``t``'s
transitions, so the updates and the collection's write touch different
buffers.  After any number of steps the read ring is bit-equal to a
single ring fed the same per-round batches in order.  Every update
samples each device's read ring and gathers the rows of all devices in
device order (:func:`replay_sample_global`), every field in **one**
collective: the sampled rows packed into one byte buffer
(:func:`pack_rows` / :func:`unpack_rows`), so a bool mask crosses any
backend as the bytes it is.

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


def replay_add_masked(buf: dict, batch: dict, n: int) -> dict:
    """Ring-write only the first ``n`` rows of a stacked batch into
    ``buf`` in place (rows from ``n`` on are dropped; ``n`` may be 0);
    returns ``buf``.  ``n`` must not exceed the capacity."""
    rows = batch["r"].shape[0]
    if not 0 <= n <= rows:
        raise ValueError(f"replay_add_masked: n={n} outside [0, {rows}]")
    return replay_add(buf, {k: batch[k][:n] for k in replay_fields(buf)})


def replay_pair_init(buf: dict, round_size: int) -> dict:
    """Wrap a fresh ring into a double-buffered pair: ``read`` (``buf``
    itself), ``write`` (a copy), ``pending`` (room for the
    ``round_size`` transitions one round writes) and ``pending_n`` (0:
    nothing pending before the first round).  ``buf`` may carry extra
    per-transition fields (the generalist's ``fleet``)."""
    pending = {k: buf[k].new_zeros((round_size,) + tuple(buf[k].shape[1:]))
               for k in replay_fields(buf)}
    write = {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in buf.items()}
    return dict(read=buf, write=write, pending=pending, pending_n=0)


def replay_pair_step(pair: dict, flat: dict) -> dict:
    """Advance the pair one round, in place; returns ``pair``.

    The write ring takes the pending batch (the previous round's, which
    brings it level with the read ring) and then ``flat``, this round's
    batch; the rings swap roles and ``flat`` becomes the pending batch.
    Each ring so takes every round's batch once, in round order, and the
    read ring is bit-equal to a single :func:`replay_add` ring fed the
    same batches.  The caller samples ``pair["read"]`` before the step.
    """
    write = replay_add_masked(pair["write"], pair["pending"],
                              pair["pending_n"])
    replay_add(write, flat)
    pair["read"], pair["write"] = write, pair["read"]
    pair["pending"] = {k: flat[k].to(write[k].dtype, copy=True)
                       for k in replay_fields(write)}
    pair["pending_n"] = flat["r"].shape[0]
    return pair


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


def pack_rows(rows: list) -> torch.Tensor:
    """Tensors (any dtypes, one device) as one flat ``uint8`` buffer:
    the tensors in the order given, whose element sizes must not grow
    (so each lies at an offset its type can be viewed at), padded to a
    multiple of 8 bytes (so the rows of a gathered ``(D, nbytes)``
    buffer stay aligned).  :func:`unpack_rows` reads it back."""
    sizes = [t.element_size() for t in rows]
    if sizes != sorted(sizes, reverse=True):
        raise ValueError(f"pack_rows: element sizes {sizes} must not grow")
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in rows])
    pad = -flat.numel() % 8
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def unpack_rows(buf: torch.Tensor, like: list) -> list:
    """Views of ``buf`` (a :func:`pack_rows` buffer, or a row of a
    gathered ``(D, nbytes)`` one) shaped and typed as the tensors of
    ``like``."""
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[at:at + n].view(t.dtype).reshape(t.shape))
        at += n
    return out


def _field_order(buf: dict) -> list:
    """The stored fields, widest element first (the packing order)."""
    return sorted(replay_fields(buf), key=lambda k: -buf[k].element_size())


def replay_sample_global(bufs: list, idxs: list, comm) -> dict:
    """A global minibatch: each local ring of ``bufs`` sampled at its
    indices of ``idxs``, packed into one byte buffer, gathered over the
    device axis by ``comm.all_gather`` (one collective) and concatenated
    in device order.  Every device returns the same ``(D * per_device,
    ...)`` batch, a sample of the union of the devices' pools.

    ``bufs`` / ``idxs`` are the shards this process holds: one (a rank
    of a process group) or all ``D`` in device order (the in-process
    oracle, whose ``all_gather`` stacks them).  With local capacity a
    multiple of the per-round write ``n``, local slot ``s`` of device
    ``d`` holds the row a ``D * capacity`` ring, fed every device's round
    batches in device-major round order, holds at ``(s // n * D + d) * n
    + s % n``: the gathered batch is a sample of that ring."""
    keys = _field_order(bufs[0])
    local = [replay_sample(b, idx=i) for b, i in zip(bufs, idxs)]
    packed = comm.all_gather([pack_rows([x[k] for k in keys])
                              for x in local])
    like = [local[0][k] for k in keys]
    shards = [unpack_rows(row, like) for row in packed]
    return {k: torch.cat([s[j] for s in shards])
            for j, k in enumerate(keys)}


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
