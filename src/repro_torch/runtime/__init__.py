"""Runtime substrate of training: failure injection and restart
supervision, gradient compression, straggler budgets and the churn
schedule's degradation draws.  The elastic restore across meshes and
the join draws are ``runtime.elastic``."""
from repro_torch.runtime.compression import (CompressionState,
                                             compress_grads,
                                             compression_ratio,
                                             decompress_grads,
                                             dequantize_int8, quantize_int8,
                                             topk_sparsify)
from repro_torch.runtime.fault import (FailureInjector, SimulatedFailure,
                                       failure_schedule, run_with_restarts)
from repro_torch.runtime.straggler import (TimeBudget, slowdown_schedule,
                                           throttle_schedule)

__all__ = [
    "SimulatedFailure", "FailureInjector", "failure_schedule",
    "run_with_restarts", "quantize_int8", "dequantize_int8",
    "CompressionState", "compress_grads", "decompress_grads",
    "topk_sparsify", "compression_ratio",
    "TimeBudget", "slowdown_schedule", "throttle_schedule",
]
