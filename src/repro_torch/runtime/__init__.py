"""Runtime substrate of LM training: failure injection and restart
supervision, gradient compression.  ``repro.runtime``'s elastic
resharding and straggler budget need more than one device and are not
ported here."""
from repro_torch.runtime.compression import (CompressionState,
                                             compress_grads,
                                             compression_ratio,
                                             decompress_grads,
                                             dequantize_int8, quantize_int8,
                                             topk_sparsify)
from repro_torch.runtime.fault import (FailureInjector, SimulatedFailure,
                                       failure_schedule, run_with_restarts)

__all__ = [
    "SimulatedFailure", "FailureInjector", "failure_schedule",
    "run_with_restarts", "quantize_int8", "dequantize_int8",
    "CompressionState", "compress_grads", "decompress_grads",
    "topk_sparsify", "compression_ratio",
]
