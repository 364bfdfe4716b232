"""Host-side metric sinks + the ``Telemetry`` session facade.

The device side accumulates (``repro_torch.telemetry.metrics``); the host
side *streams*: a :class:`Telemetry` session validates every record
against the schema (``repro_torch.telemetry.schema``) and fans it out to
pluggable :class:`MetricsSink` backends —

- :class:`JsonlSink`    one JSON object per line, flushed per record
  (a crashed run keeps everything emitted before the crash);
- :class:`ConsoleSink`  human-readable one-liners via
  ``telemetry.console.format_record`` (kinds with no console rendering
  are skipped, so the terminal log stays the familiar compact form);
- :class:`NullSink`     swallow everything (the telemetry-on /
  telemetry-off bit-parity tests run against this).

Emission happens only where the drivers already sync with the device
(round boundaries, per-tick host staging), so the sink layer adds no
device round-trips.  A copy of the JAX package's ``telemetry/sink.py``;
only :meth:`Telemetry.run_header` takes the run's ``device`` (the
``backend`` of its provenance, :func:`~repro_torch.telemetry.runmeta.
run_meta`).

Spans: ``with tele.span("collect"): ...`` times a host-side section and
emits a ``span`` record.  Sections that dispatch async device work
should close over the result's materialization (the drivers time the
rounds *including* the metrics transfer, which is the honest wall-clock
cost of the round).
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import time
import uuid

from repro_torch.telemetry.console import console_line, format_record
from repro_torch.telemetry.runmeta import run_meta
from repro_torch.telemetry.schema import SCHEMA_VERSION, validate_record


class MetricsSink:
    """Backend interface: receives schema-valid records, one at a time."""

    def emit(self, rec: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class NullSink(MetricsSink):
    """Accept and discard (telemetry machinery with zero output)."""

    def emit(self, rec: dict) -> None:
        pass


class JsonlSink(MetricsSink):
    """Append one JSON line per record to ``path`` (flushed per record)."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._f: io.TextIOBase | None = open(path, "a")

    def emit(self, rec: dict) -> None:
        if self._f is None:
            raise ValueError(f"JsonlSink({self.path!r}) already closed")
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class ConsoleSink(MetricsSink):
    """Render records as human-readable lines (``log_fn`` defaults to
    the sanctioned stdout writer; tests inject a capture)."""

    def __init__(self, log_fn=console_line):
        self.log_fn = log_fn

    def emit(self, rec: dict) -> None:
        line = format_record(rec)
        if line is not None:
            self.log_fn(line)


class ListSink(MetricsSink):
    """Collect records in memory (tests, programmatic consumers)."""

    def __init__(self):
        self.records: list[dict] = []

    def emit(self, rec: dict) -> None:
        self.records.append(rec)


class Telemetry:
    """Session facade: validate once, fan out to every sink.

    ``tele.emit(kind, **fields)`` stamps the envelope (``kind``, ``v``)
    and raises :class:`~repro_torch.telemetry.schema.SchemaError` *before*
    anything is written, so a malformed emit can never poison a stream.
    """

    def __init__(self, sinks=(), run_id: str | None = None):
        self.sinks = list(sinks)
        self.run_id = run_id or uuid.uuid4().hex[:12]

    def emit(self, kind: str, **fields) -> dict:
        rec = {"kind": kind, "v": SCHEMA_VERSION, **fields}
        validate_record(rec)
        for s in self.sinks:
            s.emit(rec)
        return rec

    def note(self, msg: str) -> None:
        """Free-form console context, kept in the stream as ``note``."""
        self.emit("note", msg=msg)

    def run_header(self, role: str, config: dict, device=None,
                   **extra) -> dict:
        """Emit the stream's header: provenance (of a run on ``device``)
        + full driver config."""
        return self.emit("run_header", run_id=self.run_id, role=role,
                         config=config, **run_meta(device), **extra)

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        """Time a host-side section and emit a ``span`` record."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.emit("span", name=name,
                      secs=round(time.perf_counter() - t0, 6), **fields)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def null_telemetry() -> Telemetry:
    """A session that validates but writes nowhere (parity tests, and
    the drivers' default when no sink flags are given)."""
    return Telemetry([NullSink()])


def make_telemetry(log_fn=None, jsonl_path: str | None = None,
                   run_id: str | None = None) -> Telemetry:
    """The drivers' standard stack: console always, JSONL when asked."""
    sinks: list[MetricsSink] = [ConsoleSink(log_fn or console_line)]
    if jsonl_path:
        sinks.append(JsonlSink(jsonl_path))
    return Telemetry(sinks, run_id=run_id)
