"""tick_mfu: the whole tick's share of the card's peak, %.

The actor's model operations in the profiled stretch (the LSTM's gate
products on live steps, ``yardstick.lstm_seq_flops``, and its two heads
on the valid slots, ``yardstick.heads_flops``) over the stretch's wall
seconds times the H100 SXM's 67 TFLOP/s (float32 outside the tensor
cores; published at the full 700 W limit, the run prints the card's
``power.limit``).  The engine's comparisons and selections are not
counted as model operations.  Source: device trace (its window).
Moves ``periods_per_s``.
"""
from portbench import yardstick as ys


def read(data):
    calls = data.get("actor_calls") or []
    if "window" not in data or not calls:
        return None
    G = data["act_dim"]
    flops = 0
    for (T, B, F), H, live in calls:
        flops += ys.lstm_seq_flops(live, F, H)
        flops += ys.heads_flops(live - B, H, G)   # less the primer rows
    return 100.0 * flops / (data["window_s"] * ys.PEAK_FP32_FLOPS)
