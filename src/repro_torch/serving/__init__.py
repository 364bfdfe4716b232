"""Multi-tenant serving plane: RELMAS (or a heuristic) schedules the
per-layer sub-jobs of tenant requests onto the simulated MAS through
device-resident request queues advanced one tick per period (the
control plane); the continuous batcher runs the LM tenants' token
generation (the data plane)."""
from repro_torch.serving.batcher import ContinuousBatcher
from repro_torch.serving.loadgen import (LoadGenConfig, request_stream,
                                         request_streams, requests_to_trace,
                                         trace_to_requests)
from repro_torch.serving.queue import (pack_admissions, queue_admit,
                                       queue_init, queue_metrics,
                                       queue_retire)
from repro_torch.serving.request import (Request, resolve_request,
                                         synth_requests)
from repro_torch.serving.service import MultiTenantService, per_tenant_metrics

__all__ = ["ContinuousBatcher", "Request", "resolve_request",
           "synth_requests", "LoadGenConfig", "request_stream",
           "request_streams", "requests_to_trace", "trace_to_requests",
           "pack_admissions", "queue_admit", "queue_init", "queue_metrics",
           "queue_retire", "MultiTenantService", "per_tenant_metrics"]
