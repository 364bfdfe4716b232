"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every kernel package holds ``ref.py`` (the plain version, used for CPU
tensors and as the oracle on the card) and ``ops.py`` (the wrapper:
checks, build on first use, launch, launch counter).  ``_build`` compiles
each ``csrc/<name>.cu`` with ``nvcc`` and loads it with ``ctypes``.
"""
