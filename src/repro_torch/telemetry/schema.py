"""JSONL event schemas for the telemetry plane.

A copy of the JAX package's ``telemetry/schema.py``: the same
``SCHEMA_VERSION``, kinds and required fields, so a stream written by
either package passes the other's validator (and
``scripts/metrics_summary.py``).  One record per line, every record a
flat-ish JSON object with two mandatory envelope fields — ``kind`` (the
record type) and ``v`` (the schema version) — plus the per-kind
required fields below.  Extra fields are always allowed (emitters
attach context freely; consumers must ignore unknown keys), so the
schema check is a *floor*, not a straitjacket.

Record kinds
------------
- ``run_header``  — first record of every stream: run identity
  (``run_id``, ``role``), provenance (``git_sha``, ``created_at``,
  ``jax_version``, ``backend``, ``host_cores``) and the full driver
  ``config`` dict.  This package never imports JAX: its headers carry
  ``jax_version: "none"`` (the field is required by schema v1) and add
  ``torch_version``, ``cuda_version``, ``device_name`` and
  ``power_limit_w`` (``telemetry.runmeta``).
- ``train_round`` — one training round: ``episode`` (last episode
  index of the round), ``sla``, ``sigma``, ``periods_per_sec``;
  optionally losses (``critic_loss``/``actor_loss``/...), the sampled
  ``fleet``, and the device telemetry block (``replay_fill``,
  ``sla_hist``, ``reward_hist``, ``committed``).
- ``train_eval``  — a chunk-boundary evaluation: ``episode``,
  ``eval_sla`` (+ optional ``per_fleet``).
- ``baseline``    — a pre-training reference score: ``name``,
  ``sla_rate``.
- ``serve_window``— one window of serving ticks: ``tick_first`` /
  ``tick_last`` (inclusive), ``tick_p50_us`` / ``tick_p99_us`` host
  wall-time quantiles, ``admitted`` / ``deferred`` / ``completed``
  counts and ``mean_depth`` over the window.
- ``serve_episode`` — one host-loop serving episode: ``episode``,
  ``sla_rate``, ``energy_uj``.
- ``tenant``      — one per-tenant SLA row (batched AND host-loop
  serving): ``tenant``, ``jobs``; ``sla_rate`` is required but may be
  null (zero counted jobs — distinct from 0.0, all missed).
- ``serve_summary`` — end-of-serving aggregate: ``sla_rate``,
  ``counted``, ``ticks``.
- ``span``        — a host-side timed section: ``name``, ``secs``.
- ``note``        — free-form console context: ``msg``.
- ``run_end``     — last record: optional summary payload.
"""
from __future__ import annotations

SCHEMA_VERSION = 1

_NUM = (int, float)
_OPT_NUM = (int, float, type(None))

# kind -> {field: type or tuple-of-types}; every kind implicitly
# requires the envelope ("kind": str, "v": int)
SCHEMAS: dict[str, dict[str, tuple | type]] = {
    "run_header": dict(run_id=str, role=str, created_at=str, git_sha=str,
                       jax_version=str, backend=str, host_cores=int,
                       config=dict),
    "train_round": dict(episode=int, sla=_NUM, sigma=_NUM,
                        periods_per_sec=_NUM),
    "train_eval": dict(episode=int, eval_sla=_NUM),
    "baseline": dict(name=str, sla_rate=_NUM),
    "serve_window": dict(tick_first=int, tick_last=int, tick_p50_us=_NUM,
                         tick_p99_us=_NUM, admitted=int, deferred=int,
                         completed=int, mean_depth=_NUM),
    "serve_episode": dict(episode=int, sla_rate=_NUM, energy_uj=_NUM),
    "tenant": dict(tenant=str, jobs=int, sla_rate=_OPT_NUM),
    "serve_summary": dict(sla_rate=_NUM, counted=int, ticks=int),
    "span": dict(name=str, secs=_NUM),
    "note": dict(msg=str),
    "run_end": dict(),
}


class SchemaError(ValueError):
    """A telemetry record failed validation."""


def validate_record(rec: dict) -> dict:
    """Validate one record against its kind's schema; returns ``rec``.

    Raises :class:`SchemaError` on a missing envelope, unknown kind,
    missing required field, or wrong field type.  Extra fields pass.
    """
    if not isinstance(rec, dict):
        raise SchemaError(f"record is not an object: {rec!r}")
    kind = rec.get("kind")
    if not isinstance(kind, str):
        raise SchemaError(f"record missing string 'kind': {rec!r}")
    if not isinstance(rec.get("v"), int):
        raise SchemaError(f"record missing int schema version 'v': {rec!r}")
    spec = SCHEMAS.get(kind)
    if spec is None:
        raise SchemaError(f"unknown record kind {kind!r} "
                          f"(known: {sorted(SCHEMAS)})")
    for field, types in spec.items():
        if field not in rec:
            raise SchemaError(f"{kind!r} record missing field "
                              f"{field!r}: {rec!r}")
        val = rec[field]
        # bool is an int subclass — reject it where a number is expected
        if isinstance(val, bool) and bool not in (
                types if isinstance(types, tuple) else (types,)):
            raise SchemaError(f"{kind!r} field {field!r} is bool, "
                              f"expected {types}: {rec!r}")
        if not isinstance(val, types):
            raise SchemaError(f"{kind!r} field {field!r} has type "
                              f"{type(val).__name__}, expected {types}: "
                              f"{rec!r}")
    return rec
