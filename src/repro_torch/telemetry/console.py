"""Console backend: the one place ``repro_torch`` writes to stdout.

:func:`console_line` is the single ``print`` call site under
``src/repro_torch`` — everything else routes through it (or through a
:class:`~repro_torch.telemetry.sink.ConsoleSink`, which formats records
with :func:`format_record` and prints via :func:`console_line`).
``tests/test_torch_isolation.py`` rejects any other ``print(`` in the
package, so ad-hoc reporting cannot creep back in beside the structured
stream.  :func:`format_record` renders every kind as the JAX package's
console does.
"""
from __future__ import annotations


def console_line(msg: str) -> None:
    """Write one human-readable line to stdout (flushed)."""
    print(msg, flush=True)


def format_record(rec: dict) -> str | None:
    """Human-readable one-liner for a telemetry record.

    Returns ``None`` for record kinds that carry no console value
    (spans, run_end, raw headers) — the ConsoleSink skips those, so the
    console output of a driver run stays the familiar compact log while
    the JSONL stream keeps everything.
    """
    kind = rec.get("kind")
    if kind == "note":
        return rec["msg"]
    if kind == "train_round":
        line = (f"[ep {rec['episode']:4d}] sla={rec['sla']:.3f} "
                f"sigma={rec['sigma']:.3f}")
        if "replay_fill" in rec:
            line += f" fill={rec['replay_fill']:.2f}"
        if "fleet" in rec:
            line += f" fleet={rec['fleet']}"
        return line
    if kind == "train_eval":
        return f"[ep {rec['episode']:4d}] eval={rec['eval_sla']:.4f}"
    if kind == "baseline":
        return f"[baseline] {rec['name']} sla={rec['sla_rate']:.4f}"
    if kind == "serve_window":
        return (f"[serve w{rec['tick_first']:3d}-{rec['tick_last']:3d}] "
                f"tick_p50={rec['tick_p50_us']:.0f}us "
                f"p99={rec['tick_p99_us']:.0f}us "
                f"admitted={rec['admitted']} deferred={rec['deferred']} "
                f"depth={rec['mean_depth']:.1f}")
    if kind == "serve_episode":
        return (f"[serve ep {rec['episode']}] sla={rec['sla_rate']:.3f} "
                f"jobs={rec.get('counted', 0)} "
                f"energy={rec['energy_uj']:.0f}uJ")
    if kind == "tenant":
        sla = rec["sla_rate"]
        sla_s = f"{sla:.3f}" if sla is not None else "n/a"
        return (f"    {rec['tenant']:>18s}: jobs={rec['jobs']:3d} "
                f"sla={sla_s}")
    if kind == "serve_summary":
        return (f"[serve] sla={rec['sla_rate']:.3f} "
                f"jobs={rec['counted']} ticks={rec['ticks']}")
    if kind == "run_header":
        return (f"[run {rec['run_id']}] role={rec['role']} "
                f"git={rec['git_sha'][:12]} backend={rec['backend']}")
    return None
