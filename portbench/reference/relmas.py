"""Plain reference of the batched RELMAS serving path, one stream at a
time, and the comparison that decides ``correct``.

What the program computes per period and stream (``serving/service.py``
staging, ``serving/queue.py`` admit and retire, ``sim/env.py`` drops,
ready queue, features and commit, ``core/policy.py``'s actor,
``sim/engine.py``'s contention engine) is written here again in NumPy
(float64) and plain PyTorch (the actor's LSTM and heads, float64), from
the configuration's own tables (``costmodel.tables``), the request
columns the benchmark drew and the actor weights it drew.

The reference follows the program period by period from the program's
own queue state: each period's start state is the program's, captured
for a sample of streams, and the reference's end state is held to the
program's next start state.  The first start state is held to an empty
queue, and the last end state goes through the reference's flush, which
is held to what ``serve_stream`` returned for that stream (its final
metrics and its completion records).  The engine is driven by the
candidate's own decisions (priorities and sub-accelerator choices), so
a tie that rounds the other way moves one period, not the rest of the
run; the decisions themselves are held to the reference actor's.

A *candidate* is what is judged: the program's capture, or the control
(``control_ticks``: this reference in the next precision below the one
the configuration states, put in the program's place).
"""
from __future__ import annotations

import numpy as np
import torch

INF = 1e30
INF32 = float(np.float32(INF))
EPS = 1e-5

# numbers compared, in the order they are printed
NUMBERS = ("prio_gap", "sa_gap", "sj_off", "job_off", "energy_gap")


# ---------------------------------------------------------------------------
# precision helpers (the control)
# ---------------------------------------------------------------------------
def round_bf16(x):
    """Round float values to bfloat16 (nearest, ties to even) and back to
    float64."""
    a = np.array(x, np.float32)
    u = a.reshape(-1).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    out = u.astype(np.uint32).view(np.float32).astype(np.float64)
    out = np.where(np.isfinite(a), out.reshape(a.shape), a)
    return float(out) if out.ndim == 0 else out


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to TF32's 10-bit mantissa (nearest, ties to
    even), as the tensor cores read a TF32 operand."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


# ---------------------------------------------------------------------------
# the actor
# ---------------------------------------------------------------------------
def actor(weights: dict, feats, mask, precision: str = "float64",
          device: str = "cpu"):
    """Actor outputs ``(B, T-1, G)`` for features ``(B, T, F)`` (primer at
    t = 0) and masks ``(B, T)``: an LSTM with zero carry whose masked
    steps keep the carry, then ``tanh(relu(h W1 + b1) W2 + b2)``.

    ``precision``: ``"float64"`` (the reference) or ``"tf32"`` (the
    control: float32 with every matrix product's operands in TF32; on a
    CUDA device through the card's TF32 path, elsewhere by rounding the
    operands)."""
    if precision == "float64":
        dt, mm = torch.float64, torch.matmul
    elif precision == "tf32":
        dt = torch.float32
        if torch.device(device).type == "cuda":
            def mm(a, b):
                old = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    return a @ b
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = old
        else:
            def mm(a, b):
                return round_tf32(a) @ round_tf32(b)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    w = {k: {n: torch.as_tensor(np.asarray(v), dtype=dt, device=device)
             for n, v in d.items()} for k, d in weights.items()}
    x = torch.as_tensor(np.asarray(feats), dtype=dt, device=device)
    m = torch.as_tensor(np.asarray(mask), dtype=torch.bool, device=device)
    B, T, _ = x.shape
    H = w["lstm"]["wh"].shape[0]
    h = x.new_zeros((B, H))
    c = x.new_zeros((B, H))
    hs = []
    with torch.no_grad():
        for t in range(T):
            g = mm(x[:, t], w["lstm"]["wx"]) + mm(h, w["lstm"]["wh"]) \
                + w["lstm"]["b"]
            gi, gf, gg, go = torch.split(g, H, dim=-1)
            c2 = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h2 = torch.sigmoid(go) * torch.tanh(c2)
            keep = m[:, t, None]
            h = torch.where(keep, h2, h)
            c = torch.where(keep, c2, c)
            hs.append(h)
        hs = torch.stack(hs, dim=1)
        z = torch.relu(mm(hs, w["fc1"]["w"]) + w["fc1"]["b"])
        a = torch.tanh(mm(z, w["fc2"]["w"]) + w["fc2"]["b"])
    return a[:, 1:].cpu().double().numpy()


# ---------------------------------------------------------------------------
# the contention engine
# ---------------------------------------------------------------------------
def engine(valid, assign, prio, cost, bw, dep, ready, sa_free, B, t_s,
           rnd=None):
    """Event-driven schedule of one ready queue (paper Sec. 3).

    Each sub-accelerator runs one sub-job at a time, non-preemptively,
    the highest priority (ties: lowest slot, by ``1e-6`` a slot) among
    the sub-jobs whose predecessor has finished, whose ready time has
    come and whose SA is idle.  All running sub-jobs share bandwidth
    ``B``: above it each progresses at ``B / demand``.  Events closer
    than ``1e-5 + 4e-6 t`` us merge (the engine's tolerance).  The loop
    stops after ``3n + M + 16`` iterations, or once no sub-job is left,
    or once the clock has passed ``t_s`` with every sub-job that started
    before it finished.  Returns ``(start, finish)`` (INF where none).

    ``rnd`` rounds every computed time, rate and progress (the control's
    lower precision); None keeps float64."""
    r = (lambda v: v) if rnd is None else rnd
    valid = np.asarray(valid, bool)
    assign = np.asarray(assign, np.int64)
    n, M = len(valid), len(sa_free)
    f = lambda v: r(np.asarray(v, np.float64))
    prio_tb = r(np.asarray(prio, np.float64) - np.arange(n) * 1e-6)
    cost, bw, ready, sa_free = f(cost), f(bw), f(ready), f(sa_free)
    dep = np.asarray(dep, np.int64)
    enab_static = np.maximum(sa_free[assign], ready)
    has_dep = dep >= 0
    dep_idx = np.maximum(dep, 0)
    started = np.zeros(n, bool)
    finished = np.zeros(n, bool)
    progress = np.zeros(n)
    start = np.full(n, INF)
    finish = np.full(n, INF)
    t = 0.0
    for _ in range(3 * n + M + 16):
        live = (valid & ~finished).any()
        early = (valid & started & (start < t_s) & ~finished).any()
        if not (live and (t < t_s or early)):
            break
        active = started & ~finished & valid
        dep_done = ~has_dep | finished[dep_idx]
        busy = np.zeros(M, bool)
        busy[assign[active]] = True
        sa_open = ~busy & (sa_free <= t + EPS)
        cand = (valid & ~started & dep_done & (ready <= t + EPS)
                & sa_open[assign])
        for m in range(M):
            idx = np.flatnonzero(cand & (assign == m))
            if idx.size:
                i = idx[np.argmax(prio_tb[idx])]   # first of the maxima
                started[i] = True
                start[i] = t
                active[i] = True
        tol = EPS + 4e-6 * t
        D = r(bw[active].sum())
        rho = r(B / max(D, 1e-9)) if D > B else 1.0
        rem = r(np.maximum(cost[active] - progress[active], 0.0)
                / max(rho, 1e-12))
        t_fin = r(t + max(rem.min(), tol)) if rem.size else INF
        pend = valid & ~started & dep_done
        enab = enab_static[pend & (enab_static > t + EPS)]
        next_t = min(t_fin, enab.min()) if enab.size else t_fin
        if not next_t < INF / 2:
            next_t = t
        progress[active] = r(progress[active] + (next_t - t) * rho)
        done = active & (progress >= cost - tol)
        finish[done] = next_t
        finished |= done
        t = next_t
    return start, finish


# ---------------------------------------------------------------------------
# one stream's queue: admit, drops, ready queue, features, commit, retire
# ---------------------------------------------------------------------------
ACC_KEYS = ("admitted", "rejected", "counted", "hits", "ten_counted",
            "ten_hit")


def empty_queue(J: int, M: int, n_models: int) -> dict:
    f32 = lambda v: np.full(J, v, np.float64)
    return dict(arrival=f32(INF32), deadline=f32(INF32), q=f32(1.0),
                model=np.zeros(J, np.int64), njl=np.zeros(J, np.int64),
                nls=np.zeros(J, np.int64), jready=f32(INF32),
                missed=np.zeros(J, bool), done=np.zeros(J, bool),
                hit=np.zeros(J, bool), fjob=f32(INF32),
                occupied=np.zeros(J, bool), rid=np.full(J, -1, np.int64),
                sa_free=np.zeros(M), t=0.0, energy=0.0,
                admitted=0, rejected=0, counted=0, hits=0,
                ten_counted=np.zeros(n_models, np.int64),
                ten_hit=np.zeros(n_models, np.int64))


def copy_queue(qs: dict) -> dict:
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in qs.items()}


def stage(cols: dict, head: int, t_now: float, K: int) -> dict:
    """The host's staging of one period: up to ``K`` requests of the
    stream that have arrived by ``t_now`` and were not admitted yet."""
    arr = cols["arrival32"]
    N = len(arr)
    n_stage = min(int((arr <= t_now).sum()) - head, K)
    idx = np.minimum(head + np.arange(K), N - 1)
    return dict(model=cols["model"][idx].astype(np.int64),
                arrival=arr[idx].astype(np.float64),
                deadline=cols["deadline32"][idx].astype(np.float64),
                q=cols["q32"][idx].astype(np.float64),
                rid=cols["rid"][idx].astype(np.int64),
                valid=np.arange(K) < n_stage)


def admit(qs: dict, adm: dict, n_layers) -> int:
    """Write the staged rows into the lowest free slots, in row order;
    rows beyond the free slots are rejected.  In place; returns the
    number admitted."""
    free = np.flatnonzero(~qs["occupied"])
    n = 0
    for k in np.flatnonzero(adm["valid"]):
        if n >= len(free):
            break
        j = free[n]
        for key in ("arrival", "deadline", "q", "model", "rid"):
            qs[key][j] = adm[key][k]
        qs["njl"][j] = n_layers[adm["model"][k]]
        qs["nls"][j] = 0
        qs["jready"][j] = adm["arrival"][k]
        qs["missed"][j] = qs["done"][j] = qs["hit"][j] = False
        qs["fjob"][j] = INF32
        qs["occupied"][j] = True
        n += 1
    qs["admitted"] += n
    qs["rejected"] += int(adm["valid"].sum()) - n
    return n


def mark_drops(qs: dict, now: float) -> None:
    overdue = ((qs["arrival"] <= now) & ~qs["done"] & ~qs["missed"]
               & (qs["deadline"] < now))
    qs["missed"] = qs["missed"] | overdue


def ready_queue(qs: dict, tab: dict, R: int) -> dict:
    """Pack the unscheduled layers of the active jobs into ``R`` slots by
    deadline (earliest first, ties by slot): a job's layers take
    consecutive slots, each depending on the one before."""
    t = qs["t"]
    lmax = tab["lmax"]
    active = (qs["arrival"] <= t) & ~qs["done"] & ~qs["missed"]
    rem = np.where(active, qs["njl"] - qs["nls"], 0)
    key = np.where(active & (rem > 0), qs["deadline"], INF)
    job, layer = [], []
    for j in np.argsort(key, kind="stable"):
        for li in range(int(rem[j])):
            job.append(j)
            layer.append(qs["nls"][j] + li)
    job, layer = np.array(job[:R], np.int64), np.array(layer[:R], np.int64)
    nv = len(job)
    valid = np.arange(R) < nv
    jb = np.zeros(R, np.int64)
    jb[:nv] = job
    ly = np.zeros(R, np.int64)
    ly[:nv] = np.minimum(layer, lmax - 1)
    dep = np.full(R, -1, np.int64)
    for i in range(1, nv):
        if jb[i] == jb[i - 1]:
            dep[i] = i - 1
    model = qs["model"][jb]
    ready = np.where(valid & (dep < 0),
                     np.maximum(qs["jready"][jb] - t, 0.0), 0.0)
    z = valid[:, None]
    return dict(job=jb, layer=ly, valid=valid, dep=dep, model=model,
                ready=ready,
                cost_all=np.where(z, tab["lat32"][model, ly], 0.0),
                bw_all=np.where(z, tab["bw32"][model, ly], 0.0),
                en_all=np.where(z, tab["en32"][model, ly], 0.0),
                deadline=qs["deadline"][jb], arrival=qs["arrival"][jb])


def features(qs: dict, sl: dict, tab: dict, env: dict):
    """(T, F) features with the primer row first, and the (T,) mask."""
    t, ts = qs["t"], env["t_s_us"]
    tsn = ts * env["ttd_norm_periods"]
    v = sl["valid"][:, None].astype(np.float64)
    rows = np.concatenate([
        ((sl["model"] + 1.0) / tab["num_models"])[:, None],
        ((sl["layer"] + 1.0) / tab["lmax"])[:, None],
        np.clip((sl["deadline"] - t) / tsn, -1.0, 1.0)[:, None],
        np.clip((t - sl["arrival"]) / tsn, 0.0, 1.0)[:, None],
        np.clip(sl["cost_all"] / ts, 0.0, 2.0) / 2.0,
        sl["bw_all"] / tab["dram_gbps"]], axis=1) * v
    busy = np.maximum(qs["sa_free"] - t, 0.0) / ts
    M = tab["num_sas"]
    primer = np.concatenate([np.zeros(4), np.clip(busy, 0.0, 4.0) / 4.0,
                             np.zeros(M)])
    return (np.concatenate([primer[None], rows]),
            np.concatenate([[True], sl["valid"]]))


def engine_inputs(qs: dict, sl: dict, assign) -> dict:
    a = np.asarray(assign, np.int64)
    pick = lambda x: x[np.arange(len(a)), a]
    return dict(valid=sl["valid"], dep=sl["dep"], ready=sl["ready"],
                cost=pick(sl["cost_all"]), bw=pick(sl["bw_all"]),
                en=pick(sl["en_all"]),
                sa_free=np.maximum(qs["sa_free"] - qs["t"], 0.0))


def commit(qs: dict, sl: dict, start, fin, en, assign, t_s: float,
           rnd=None) -> int:
    """Commit the sub-jobs that started inside the period (they run to
    completion), advance the jobs, the SAs' free times, the energy and
    the clock.  In place; returns the number that started before
    ``t_s`` (the period's ``committed`` count)."""
    r = (lambda v: v) if rnd is None else rnd
    t = qs["t"]
    valid = sl["valid"]
    com = valid & (start < t_s - 1e-6) & (fin < INF / 2)
    J = len(qs["nls"])
    ncom = np.zeros(J, np.int64)
    jlast = np.full(J, -INF)
    for i in np.flatnonzero(com):
        j = sl["job"][i]
        ncom[j] += 1
        jlast[j] = max(jlast[j], fin[i])
    nls = qs["nls"] + ncom
    jready = np.where(ncom > 0, r(t + jlast), qs["jready"])
    newly = ((qs["arrival"] <= t) & ~qs["done"] & ~qs["missed"]
             & (nls >= qs["njl"]) & (ncom > 0))
    qs["fjob"] = np.where(newly, jready, qs["fjob"])
    qs["hit"] = qs["hit"] | (newly & (qs["fjob"] <= qs["deadline"]))
    qs["done"] = qs["done"] | newly
    qs["nls"], qs["jready"] = nls, jready
    qs["energy"] = float(r(qs["energy"] + np.asarray(en)[com].sum()))
    a = np.asarray(assign, np.int64)
    for m in range(len(qs["sa_free"])):
        sel = com & (a == m)
        if sel.any():
            qs["sa_free"][m] = max(qs["sa_free"][m],
                                   float(r(t + fin[sel].max())))
    qs["t"] = t + t_s
    return int((valid & (start < t_s)).sum())


def retire(qs: dict, n_models: int) -> dict:
    """Fold completed jobs (done or missed) into the accumulators, free
    their slots and return the completion record.  In place."""
    comp = qs["occupied"] & (qs["done"] | qs["missed"])
    hit = qs["hit"] & comp
    qs["counted"] += int(comp.sum())
    qs["hits"] += int(hit.sum())
    qs["ten_counted"] = qs["ten_counted"] + np.bincount(
        qs["model"][comp], minlength=n_models)
    qs["ten_hit"] = qs["ten_hit"] + np.bincount(qs["model"][hit],
                                                minlength=n_models)
    out = dict(completed=comp, rid=qs["rid"].copy(), hit=qs["hit"].copy(),
               missed=qs["missed"].copy(), finish_us=qs["fjob"].copy(),
               depth=int(qs["occupied"].sum() - comp.sum()))
    qs["arrival"] = np.where(comp, INF32, qs["arrival"])
    qs["occupied"] = qs["occupied"] & ~comp
    return out


def records(out: dict) -> list[tuple]:
    return [(int(out["rid"][j]), bool(out["hit"][j]),
             bool(out["missed"][j]), float(out["finish_us"][j]))
            for j in np.flatnonzero(out["completed"])]


# ---------------------------------------------------------------------------
# the deployment's tables and one stream's columns
# ---------------------------------------------------------------------------
def prepare_tables(tab: dict) -> dict:
    """Float32 copies of the tables as the scheduler reads them."""
    out = dict(tab)
    for k in ("lat", "bw", "en"):
        out[k + "32"] = tab[k].astype(np.float32).astype(np.float64)
    out["num_models"] = len(tab["names"])
    return out


def stream_columns(cols: dict) -> dict:
    """A stream's columns in arrival order, times as float32 (the queue's
    type) widened back to float64."""
    order = np.argsort(cols["arrival"], kind="stable")
    w = lambda k: np.asarray(cols[k])[order].astype(np.float32).astype(
        np.float64)
    return dict(rid=np.asarray(cols["rid"])[order],
                model=np.asarray(cols["model"])[order],
                arrival32=w("arrival"), deadline32=w("deadline"),
                q32=w("q"))


# ---------------------------------------------------------------------------
# the control: this reference in the next precision down, as a candidate
# ---------------------------------------------------------------------------
def control_ticks(ticks: list, cols: dict, a_ctl, tab: dict, env: dict,
                  K: int) -> list:
    """The control's periods: from each of the program's start states
    ``ticks[t]["pre"]``, one period computed by the control (the actor's
    outputs ``a_ctl`` (periods, R, G) taken with TF32 products, the
    engine and the commit in bfloat16), in the layout of a capture."""
    ts = env["t_s_us"]
    head = 0
    out_ticks = []
    for t, tk in enumerate(ticks):
        qs = copy_queue(tk["pre"])
        adm = stage(cols, head, t * ts, K)
        n_adm = admit(qs, adm, tab["n_layers"])
        head += n_adm
        mark_drops(qs, qs["t"])
        sl = ready_queue(qs, tab, env["max_rq"])
        prio = a_ctl[t][:, 0]
        assign = np.argmax(a_ctl[t][:, 1:], axis=1)
        ei = engine_inputs(qs, sl, assign)
        start, fin = engine(ei["valid"], assign, prio, ei["cost"], ei["bw"],
                            ei["dep"], ei["ready"], ei["sa_free"],
                            tab["dram_gbps"], ts, rnd=round_bf16)
        committed = commit(qs, sl, start, fin, ei["en"], assign, ts,
                           rnd=round_bf16)
        out = retire(qs, tab["num_models"])
        out.update(n_admitted=n_adm, committed=committed)
        out_ticks.append(dict(
            pre=tk["pre"], adm=adm, out=out, post=qs,
            eng=dict(valid=ei["valid"], assign=assign, prio=prio,
                     cost=ei["cost"], bw=ei["bw"], dep=ei["dep"],
                     ready=ei["ready"], sa_free=ei["sa_free"],
                     start=start, finish=fin)))
    return out_ticks


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------
class Tally:
    """The numbers compared, accumulated over periods and streams."""

    def __init__(self, tol_us: float):
        self.tol_us = tol_us
        self.prio_gap = 0.0
        self.sa_gap = 0.0
        self.energy_gap = 0.0
        self.sj = [0, 0]       # [off, compared]
        self.job = [0, 0]
        self.notes: list[str] = []

    def item(self, which, ok: bool, note: str = "") -> None:
        which[1] += 1
        if not ok:
            which[0] += 1
            if note and len(self.notes) < 20:
                self.notes.append(note)

    def times_ok(self, x, y) -> bool:
        x, y = float(x), float(y)
        if x >= INF / 2 or y >= INF / 2:
            return (x >= INF / 2) == (y >= INF / 2)
        return abs(x - y) <= self.tol_us

    def readings(self) -> dict:
        return dict(prio_gap=self.prio_gap, sa_gap=self.sa_gap,
                    sj_off=self.sj[0] / max(self.sj[1], 1),
                    job_off=self.job[0] / max(self.job[1], 1),
                    energy_gap=self.energy_gap)


def compare_state(tl: Tally, ref: dict, cand: dict, where: str) -> None:
    for j in range(len(ref["nls"])):
        ok = True
        for k in ("occupied", "rid", "model", "njl", "nls", "missed",
                  "done", "hit", "arrival", "deadline", "q"):
            ok &= bool(ref[k][j] == cand[k][j])
        for k in ("jready", "fjob"):
            ok &= tl.times_ok(ref[k][j], cand[k][j])
        tl.item(tl.job, ok, f"{where} job {j}")
    for m in range(len(ref["sa_free"])):
        tl.item(tl.job, tl.times_ok(ref["sa_free"][m], cand["sa_free"][m]),
                f"{where} sa_free {m}")
    tl.item(tl.job, ref["t"] == cand["t"], f"{where} clock")
    for k in ACC_KEYS:
        tl.item(tl.job, bool(np.array_equal(ref[k], cand[k])),
                f"{where} {k}")
    den = max(abs(ref["energy"]), 1e-30)
    tl.energy_gap = max(tl.energy_gap,
                        abs(cand["energy"] - ref["energy"]) / den)


def compare_out(tl: Tally, ref: dict, cand: dict, where: str) -> None:
    comp = ref["completed"]
    ok = bool(np.array_equal(comp, cand["completed"]))
    tl.item(tl.job, ok, f"{where} completed set")
    for j in np.flatnonzero(comp & cand["completed"]):
        tl.item(tl.job, bool(ref["rid"][j] == cand["rid"][j]
                             and ref["hit"][j] == cand["hit"][j]
                             and ref["missed"][j] == cand["missed"][j])
                and tl.times_ok(ref["finish_us"][j], cand["finish_us"][j]),
                f"{where} record {j}")
    for k in ("depth", "n_admitted", "committed"):
        tl.item(tl.job, int(ref[k]) == int(cand[k]), f"{where} {k}")


def check_stream(tl: Tally, cols: dict, ticks: list, completions, metrics,
                 a_ref, tab: dict, env: dict, K: int) -> None:
    """Hold one stream's periods to the reference.

    ``ticks[t]``: the candidate's period ``t``: ``pre`` (the start state
    the reference starts from), ``adm`` (the staged rows), ``eng`` (the
    engine's inputs, decisions and results), ``out`` (the completion
    record) and ``post`` (the candidate's state after the period; the
    last one is what the candidate flushed).  ``completions`` and
    ``metrics``: what the serving call returned for this stream (None
    for the control).  ``a_ref``
    (periods, R, G): the reference actor's outputs on the reference's
    features of each period, computed by :func:`reference_features` and
    :func:`actor` beforehand (so that the actor runs once over all
    periods)."""
    ts = env["t_s_us"]
    M, nm = tab["num_sas"], tab["num_models"]
    empty = empty_queue(len(ticks[0]["pre"]["nls"]), M, nm)
    compare_state(tl, empty, ticks[0]["pre"], "start")
    head = 0
    recs = []
    for t, tk in enumerate(ticks):
        where = f"period {t}"
        adm = stage(cols, head, t * ts, K)
        for k in ("valid", "model", "rid", "arrival", "deadline", "q"):
            same = np.array_equal(adm[k][adm["valid"]],
                                  tk["adm"][k][tk["adm"]["valid"]])
            tl.item(tl.job, bool(same) and np.array_equal(
                adm["valid"], tk["adm"]["valid"]), f"{where} staged {k}")
        qs = copy_queue(tk["pre"])
        n_adm = admit(qs, adm, tab["n_layers"])
        head += n_adm
        mark_drops(qs, qs["t"])
        sl = ready_queue(qs, tab, env["max_rq"])
        e = tk["eng"]
        assign = np.asarray(e["assign"], np.int64)
        v = sl["valid"]
        tl.item(tl.sj, bool(np.array_equal(v, e["valid"])
                            and np.array_equal(sl["dep"], e["dep"])),
                f"{where} ready queue")
        ei = engine_inputs(qs, sl, assign)
        for i in np.flatnonzero(v):
            ok = (ei["cost"][i] == e["cost"][i] and ei["bw"][i] == e["bw"][i]
                  and tl.times_ok(ei["ready"][i], e["ready"][i]))
            tl.item(tl.sj, bool(ok), f"{where} slot {i} inputs")
        for m in range(M):
            tl.item(tl.sj, tl.times_ok(ei["sa_free"][m], e["sa_free"][m]),
                    f"{where} sa {m} free")
        # the candidate's decisions against the reference actor
        a = a_ref[t]
        if v.any():
            tl.prio_gap = max(tl.prio_gap, float(np.max(np.abs(
                np.asarray(e["prio"], np.float64)[v] - a[v, 0]))))
            ch = a[:, 1:]
            tl.sa_gap = max(tl.sa_gap, float(np.max(
                ch[v].max(axis=1) - ch[np.flatnonzero(v), assign[v]])))
        # the engine on the candidate's decisions
        start, fin = engine(v, assign, e["prio"], ei["cost"], ei["bw"],
                            sl["dep"], ei["ready"], ei["sa_free"],
                            tab["dram_gbps"], ts)
        cs, cf = np.asarray(e["start"]), np.asarray(e["finish"])
        for i in np.flatnonzero(v):
            rc = start[i] < ts - 1e-6 and fin[i] < INF / 2
            cc = cs[i] < ts - 1e-6 and cf[i] < INF / 2
            ok = rc == cc and (not rc or (tl.times_ok(start[i], cs[i])
                                          and tl.times_ok(fin[i], cf[i])))
            tl.item(tl.sj, bool(ok), f"{where} slot {i} schedule")
        committed = commit(qs, sl, start, fin, ei["en"], assign, ts)
        out = retire(qs, nm)
        out.update(n_admitted=n_adm, committed=committed)
        compare_out(tl, out, tk["out"], where)
        recs += records(out)
        compare_state(tl, qs, tk["post"], f"after {where}")
    # the flush: a last drop pass and retire, then the metrics
    qs = copy_queue(ticks[-1]["post"])
    mark_drops(qs, qs["t"])
    out = retire(qs, nm)
    recs += records(out)
    if completions is not None:
        tl.item(tl.job, len(completions) == len(recs), "completion count")
        for got, want in zip(completions, recs):
            ok = (got["rid"] == want[0] and got["hit"] == want[1]
                  and got["missed"] == want[2]
                  and tl.times_ok(got["finish_us"], want[3]))
            tl.item(tl.job, ok, f"completion rid {want[0]}")
    if metrics is not None:
        for k in ("hits", "counted"):
            tl.item(tl.job, int(metrics[k]) == qs[k], f"final {k}")
        tl.item(tl.job, int(metrics["arrived"]) == qs["admitted"],
                "final arrived")
        rate = np.float32(qs["hits"]) / np.float32(max(qs["counted"], 1))
        tl.item(tl.job, abs(metrics["sla_rate"] - float(rate)) <= 1e-6,
                "final sla_rate")
        den = max(abs(qs["energy"]), 1e-30)
        tl.energy_gap = max(tl.energy_gap,
                            abs(metrics["energy_uj"] - qs["energy"]) / den)


def reference_features(cols: dict, ticks: list, tab: dict, env: dict,
                       K: int):
    """The reference's features and masks of every period of one stream,
    from the candidate's start states: ``(periods, T, F)``, ``(periods,
    T)``."""
    head = 0
    fs, ms = [], []
    for t, tk in enumerate(ticks):
        adm = stage(cols, head, t * env["t_s_us"], K)
        qs = copy_queue(tk["pre"])
        head += admit(qs, adm, tab["n_layers"])
        mark_drops(qs, qs["t"])
        f, m = features(qs, ready_queue(qs, tab, env["max_rq"]), tab, env)
        fs.append(f)
        ms.append(m)
    return np.stack(fs), np.stack(ms)
