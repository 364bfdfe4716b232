"""Telemetry plane: device-resident metrics, JSONL sinks, profiler hooks.

The counterpart of the JAX package's ``repro.telemetry``, with the
same two halves and the same boundary:

- **On the device** (``repro_torch.telemetry.metrics``): counters,
  gauges and fixed-bucket histograms as pure tensor reducers inside the
  training round and the serving tick — accumulated on the device,
  bit-neutral to every existing output, crossing to the host only in
  the transfers the paths already make (the round's one metrics
  transfer, the serving flush).
- **On the host** (``sink`` / ``schema`` / ``console`` / ``runmeta`` /
  ``profiler``): a :class:`Telemetry` session validates schema'd
  records (the JAX package's schema v1) and streams them to console /
  JSONL / null backends, times host sections as ``span`` records,
  stamps run provenance (git SHA, ISO timestamp, torch identity, the
  card and its power limit), and gates ``torch.profiler`` trace
  capture.

See the README's port section for the flags, the record kinds and the
scope names; ``scripts/metrics_summary.py`` validates the streams.
"""
from repro_torch.telemetry.console import console_line, format_record
from repro_torch.telemetry.metrics import (REWARD_EDGES, ROUND_TELE_COUNTS,
                                           ROUND_TELE_GAUGES,
                                           ROUND_TELE_KEYS, SLA_EDGES,
                                           counter_add, counter_init,
                                           gauge_init, gauge_set, hist_add,
                                           hist_init, hist_mean, hist_merge,
                                           hist_quantile, round_telemetry)
from repro_torch.telemetry.profiler import profile_trace
from repro_torch.telemetry.runmeta import git_sha, iso_now, run_meta
from repro_torch.telemetry.schema import (SCHEMA_VERSION, SCHEMAS,
                                          SchemaError, validate_record)
from repro_torch.telemetry.sink import (ConsoleSink, JsonlSink, ListSink,
                                        MetricsSink, NullSink, Telemetry,
                                        make_telemetry, null_telemetry)

__all__ = [
    "SCHEMA_VERSION", "SCHEMAS", "SchemaError", "validate_record",
    "SLA_EDGES", "REWARD_EDGES", "ROUND_TELE_COUNTS", "ROUND_TELE_GAUGES",
    "ROUND_TELE_KEYS", "counter_init", "counter_add", "gauge_init",
    "gauge_set", "hist_init", "hist_add", "hist_merge", "hist_quantile",
    "hist_mean", "round_telemetry", "console_line", "format_record",
    "git_sha", "iso_now", "run_meta", "profile_trace", "MetricsSink",
    "NullSink", "JsonlSink", "ConsoleSink", "ListSink", "Telemetry",
    "make_telemetry", "null_telemetry",
]
