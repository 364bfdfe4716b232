"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``lstm_seq``: the actor's LSTM over a whole sequence (serving tick);
- ``flash_attention``: causal prefill attention of the dense LM;
- ``decode_gqa``: one-token grouped-query decode attention;
- ``ssd_chunk``: the Mamba-2 SSD intra-chunk term (prefill), with the
  SSD forward built on it;
- ``lstm_cell``: one fused LSTM step, the step of the policy's
  recurrence in training (an ``autograd.Function`` with a plain
  backward);
- ``event_loop``: the contention engine's whole event loop, a warp a
  stream (``sim/engine.py::simulate`` on the card; its plain version,
  ``ref.loop``, is the engine on the CPU).

Every kernel package holds ``ref.py`` (the plain version, used for CPU
tensors and as the oracle on the card) and ``ops.py`` (the wrapper:
checks, build on first use, launch, launch counter).  ``_build`` compiles
each ``csrc/<name>.cu`` with ``nvcc`` and loads it with ``ctypes``.
"""
