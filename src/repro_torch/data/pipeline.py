"""Deterministic, resumable token pipeline: a NumPy copy of
``repro.data.pipeline``, shared ground truth with the JAX package (the
same seed and step give the same tokens, bit for bit).

Design points for large-scale training:
- **Step-indexed determinism**: batch ``i`` is a pure function of
  (seed, i) — restart-after-failure resumes mid-epoch with no state
  file beyond the step counter already in the checkpoint, and elastic
  re-runs produce identical batches regardless of host count.
- **Host sharding**: each host materializes only its slice
  (``host_id/num_hosts``) of the global batch; a single-process run
  has one host, and the tests exercise the slicing path.
- **Synthetic LM stream**: Zipf-distributed unigrams overlaid with
  repeated bigram motifs, so CE loss decreases measurably within a few
  hundred steps of the e2e example (pure noise would pin loss at
  ln(vocab)).
- **File-backed mode**: a flat binary (np.memmap) of token ids can
  replace the synthetic stream (same step-indexed slicing).
"""
from __future__ import annotations

import dataclasses

import numpy as np


def synthetic_batch(seed: int, step: int, batch: int, seq: int,
                    vocab: int) -> np.ndarray:
    """(batch, seq) int32, pure function of (seed, step)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # zipf unigrams (clipped to vocab)
    toks = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    toks = (toks - 1) % vocab
    # motif overlay: learnable bigram structure (tok -> (tok*7+3) % vocab)
    follow = rng.random((batch, seq)) < 0.5
    nxt = (toks * 7 + 3) % vocab
    toks[:, 1:] = np.where(follow[:, 1:], nxt[:, :-1], toks[:, 1:])
    return toks.astype(np.int32)


@dataclasses.dataclass
class TokenPipeline:
    batch: int                 # GLOBAL batch
    seq: int
    vocab: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    path: str | None = None    # optional flat int32 token file

    def __post_init__(self):
        if self.batch % self.num_hosts:
            raise ValueError(f"batch {self.batch} is not a multiple of "
                             f"num_hosts {self.num_hosts}")
        self._mm = (np.memmap(self.path, dtype=np.int32, mode="r")
                    if self.path else None)

    @property
    def host_batch(self) -> int:
        return self.batch // self.num_hosts

    def get(self, step: int) -> dict[str, np.ndarray]:
        """Host-local slice of global batch ``step`` (resumable)."""
        if self._mm is not None:
            toks = self._file_batch(step)
        else:
            toks = synthetic_batch(self.seed, step, self.batch, self.seq,
                                   self.vocab)
        lo = self.host_id * self.host_batch
        return {"tokens": toks[lo:lo + self.host_batch]}

    def _file_batch(self, step: int) -> np.ndarray:
        n = self.batch * self.seq
        total = len(self._mm) - self.seq
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, step, 7]))
        starts = rng.integers(0, max(total, 1), size=self.batch)
        out = np.stack([np.asarray(self._mm[s:s + self.seq])
                        for s in starts])
        return (out % self.vocab).astype(np.int32)

    def __iter__(self):
        step = 0
        while True:
            yield self.get(step)
            step += 1
