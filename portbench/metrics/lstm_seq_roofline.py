"""lstm_seq_roofline: the actor kernel's share of its roofline
(``kernels/lstm_seq``, the serving route of ``core/policy.py``), %.

The least time of the profiled launches, from the operations and bytes
their inputs need (``yardstick.lstm_seq_flops`` / ``lstm_seq_bytes``:
live steps only) at the H100 SXM's published peaks (67 TFLOP/s float32
outside the tensor cores, the actor's precision with TF32 off; 3.35
TB/s), over the device time of the kernels named ``lstm_seq`` in the
profile.  The peaks assume the full 700 W power limit; the run prints
the card's ``power.limit`` on standard error.  Source: device trace.
Moves ``periods_per_s``.
"""
from portbench import yardstick as ys


def read(data):
    if "window" not in data:
        return None
    lo, hi = data["window"]
    dev = sum(e - s for name, s, e in data["device_events"]
              if "lstm_seq" in name and lo <= s < hi)
    calls = data.get("actor_calls") or []
    if dev <= 0 or not calls:
        return None
    least = 0.0
    for (T, B, F), H, live in calls:
        least += ys.least_seconds(ys.lstm_seq_flops(live, F, H),
                                  ys.lstm_seq_bytes(T, B, live, F, H))
    return 100.0 * least / dev
