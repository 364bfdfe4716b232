"""Runner of the RELMAS serving cells: calls of the port's
``MultiTenantService.serve_stream`` one after another, each serving the
cell's streams for one episode of periods.

Set-up builds the service (the program's registry, environment and
actor), draws the served policy's weights on the device from the
configuration's ``policy_seed``, puts their hidden units in an order
drawn from the run's seed and loads them through ``Actor.load_numpy``
(a deployment serves one trained policy: random policies differ in the
work they cause, so every seed serves the same one, its weights in
another order), draws the calls' request streams with the benchmark's
generator, and serves a warm-up call of a few periods at the cell's
shapes.  The window then serves the drawn calls in turn until
``--seconds`` have passed, and ends with the call that is running then.

The benchmark's own wrappers sit at the module attributes that the
program reads at call time: ``core.serve.make_serving_tick`` and
``make_serving_flush`` (``serving/service.py``), ``sim.engine.simulate``
(``sim/env.py``) and ``kernels.lstm_seq.ops.lstm_seq``
(``core/policy.py``).  In every run the tick wrapper reads the host
clock at entry (a period runs from one tick's entry to the next's; the
last ends when ``serve_stream`` returns) and copies the queue rows of a
few sampled streams, which the reference checks after the window; the
host seconds of that copy are summed (``capture_s``).  In
the traced run the tick and engine wrappers also synchronise and time
their calls, and a few periods of the first call run under
``torch.profiler``.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import traffic as gen
from portbench import yardstick as ys
from portbench.reference import costmodel
from portbench.reference import relmas as ref

PRE_TRACE = ("arrival", "deadline", "q", "model", "njl")
PRE_STATE = ("nls", "jready", "missed", "done", "hit", "fjob", "sa_free",
             "t", "energy")
PRE_ACC = ref.ACC_KEYS
ADM = ("model", "arrival", "deadline", "q", "rid", "valid")
ENG = ("valid", "assign", "prio", "cost", "bw", "dep", "ready", "sa_free")
OUT = ("completed", "rid", "hit", "missed", "finish_us", "depth",
       "n_admitted", "committed")


# ---------------------------------------------------------------------------
# set-up
# ---------------------------------------------------------------------------
def build_service(config: dict, device: str):
    """The port's service for the configuration (its own registry, built
    from the fleet's and the tenant set's names)."""
    from repro_torch.serving.service import MultiTenantService
    from repro_torch.sim.arrivals import ArrivalConfig
    from repro_torch.sim.env import EnvConfig
    from repro_torch.workloads import build_registry
    ten, e, a = config["tenants"], config["env"], config["arrivals"]
    reg = build_registry(ten["set"], mas=config["fleet"]["name"])
    if reg.model_names != list(ten["models"]):
        raise ValueError(f"the program's tenants {reg.model_names} are not "
                         f"the configuration's {ten['models']}")
    ecfg = EnvConfig(t_s_us=e["t_s_us"], periods=e["periods"],
                     max_rq=e["max_rq"], max_jobs=e["max_jobs"],
                     ttd_norm_periods=e["ttd_norm_periods"])
    arr = ArrivalConfig(max_jobs=e["max_jobs"], load=a["load"],
                        eff_parallelism=a["eff_parallelism"],
                        qos_factor=a["qos_factor"],
                        qos_level=a["qos_level"],
                        horizon_us=ecfg.horizon_us, slack_us=a["slack_us"])
    return MultiTenantService(reg, policy="relmas",
                              hidden=config["policy"]["hidden"],
                              env_cfg=ecfg, arrivals=arr, device=device)


def draw_weights(policy_seed: int, F: int, H: int, G: int, device) -> dict:
    """The served policy's weights: one uniform draw on the device from
    the configuration's ``policy_seed``, cut into the leaves; matrices
    scaled as Glorot-uniform, biases by 0.1, the forget gate's bias
    raised by 1."""
    shapes = [("lstm", "wx", (F, 4 * H)), ("lstm", "wh", (H, 4 * H)),
              ("lstm", "b", (4 * H,)), ("fc1", "w", (H, H // 2)),
              ("fc1", "b", (H // 2,)), ("fc2", "w", (H // 2, G)),
              ("fc2", "b", (G,))]
    sizes = [int(np.prod(s)) for _, _, s in shapes]
    g = torch.Generator(device=device)
    g.manual_seed(policy_seed)
    u = (torch.rand(sum(sizes), generator=g, device=device) * 2.0 - 1.0)
    u = u.cpu().numpy()
    tree: dict = {"lstm": {}, "fc1": {}, "fc2": {}}
    off = 0
    for (mod, leaf, shape), n in zip(shapes, sizes):
        x = u[off:off + n].reshape(shape)
        off += n
        if len(shape) == 2:
            x = x * np.float32(np.sqrt(6.0 / (shape[0] + shape[1])))
        else:
            x = x * np.float32(0.1)
        tree[mod][leaf] = x.astype(np.float32)
    tree["lstm"]["b"][H:2 * H] += np.float32(1.0)
    return tree


def permute_hidden(tree: dict, seed: int) -> dict:
    """The same policy with its LSTM's hidden units and its first head's
    units in an order drawn from ``seed``: every weight moves, the
    function does not (but for the order of float sums)."""
    H = tree["lstm"]["wh"].shape[0]
    rng = np.random.default_rng([seed, 3 << 20])
    p, q = rng.permutation(H), rng.permutation(H // 2)
    cols = np.concatenate([k * H + p for k in range(4)])
    return {"lstm": {"wx": tree["lstm"]["wx"][:, cols],
                     "wh": tree["lstm"]["wh"][p][:, cols],
                     "b": tree["lstm"]["b"][cols]},
            "fc1": {"w": tree["fc1"]["w"][p][:, q], "b": tree["fc1"]["b"][q]},
            "fc2": {"w": tree["fc2"]["w"][q], "b": tree["fc2"]["b"]}}


def to_requests(cols_list: list, names: list) -> list:
    from repro_torch.serving.request import Request
    return [[Request(rid=int(r), tenant=names[int(m)], arrival_us=float(a),
                     deadline_us=float(d), q_us=float(q))
             for r, m, a, d, q in zip(c["rid"], c["model"], c["arrival"],
                                      c["deadline"], c["q"])]
            for c in cols_list]


def sample_streams(S: int, k: int, seed: int, call: int) -> np.ndarray:
    """``k`` streams of call ``call`` drawn from the seed, one in each of
    ``k`` equal blocks of the stream axis."""
    rng = np.random.default_rng([seed, 1 << 20, call])
    block = S // k
    return np.array([b * block + int(rng.integers(block))
                     for b in range(k)])


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------
class Recorder:
    """What the wrappers record.  ``idx`` (device tensor): the sampled
    streams of the current call, or None; ``sync``: time the tick and the
    engine calls to their end on the device (traced run)."""

    def __init__(self, device):
        self.device = device
        self.synchronize = (torch.cuda.synchronize
                            if torch.device(device).type == "cuda"
                            else (lambda: None))
        self.sync = False
        self.idx = None
        self.entries: list = []
        self.tick_s: list = []
        self.engine_s: list = []
        self.cap: dict = {}
        self.cap_s = 0.0
        self.on_entry = None
        self.count_actor = False
        self.actor_calls: list = []

    def take(self, group: str, tensors: dict, keys) -> None:
        if self.idx is None:
            return
        t0 = time.perf_counter()
        rows = self.cap.setdefault(group, {})
        for k in keys:
            rows.setdefault(k, []).append(
                tensors[k].index_select(0, self.idx))
        self.cap_s += time.perf_counter() - t0

    def take_queue(self, group: str, queues: dict) -> None:
        self.take(group, queues["trace"], PRE_TRACE)
        self.take(group, queues["state"], PRE_STATE)
        self.take(group, queues["acc"], PRE_ACC)
        self.take(group, queues, ("occupied", "rid"))

    def begin_call(self, idx) -> None:
        self.entries = []
        self.tick_s = []
        self.engine_s = []
        self.cap = {}
        self.cap_s = 0.0
        self.idx = (None if idx is None
                    else torch.as_tensor(idx, device=self.device))


def install(rec: Recorder):
    """Put the wrappers in place; returns a function that takes them
    out again."""
    from repro_torch.core import serve as core_serve
    from repro_torch.kernels.lstm_seq import ops as lstm_ops
    from repro_torch.sim import engine
    orig = dict(tick=core_serve.make_serving_tick,
                flush=core_serve.make_serving_flush,
                sim=engine.simulate, lstm=lstm_ops.lstm_seq)

    def make_tick(env, **kw):
        tick = orig["tick"](env, **kw)

        def timed(queues, adm):
            t0 = time.perf_counter()
            rec.entries.append(t0)
            if rec.on_entry is not None:
                rec.on_entry(len(rec.entries) - 1)
            rec.take_queue("pre", queues)
            rec.take("adm", adm, ADM)
            out = tick(queues, adm)
            rec.take("out", out, OUT)
            if rec.sync:
                rec.synchronize()
            rec.tick_s.append(time.perf_counter() - t0 if rec.sync
                              else None)
            return out
        return timed

    def make_flush(env):
        flush = orig["flush"](env)

        def wrapped(queues):
            rec.take_queue("final", queues)
            return flush(queues)
        return wrapped

    def simulate(valid, assign, prio, cost, bw, dep, ready, sa_free, B,
                 **kw):
        sync = rec.sync
        if sync:
            rec.synchronize()
        t0 = time.perf_counter()
        start, fin = orig["sim"](valid, assign, prio, cost, bw, dep, ready,
                                 sa_free, B, **kw)
        if sync:
            rec.synchronize()
        rec.engine_s.append(time.perf_counter() - t0 if sync else None)
        rec.take("eng", dict(valid=valid, assign=assign, prio=prio,
                             cost=cost, bw=bw, dep=dep, ready=ready,
                             sa_free=sa_free, start=start, finish=fin),
                 ENG + ("start", "finish"))
        return start, fin

    def lstm_seq(xs, mask, wx, wh, b):
        if rec.count_actor:
            rec.actor_calls.append((tuple(xs.shape), wh.shape[0],
                                    mask.sum()))
        return orig["lstm"](xs, mask, wx, wh, b)

    core_serve.make_serving_tick = make_tick
    core_serve.make_serving_flush = make_flush
    engine.simulate = simulate
    lstm_ops.lstm_seq = lstm_seq

    def remove():
        core_serve.make_serving_tick = orig["tick"]
        core_serve.make_serving_flush = orig["flush"]
        engine.simulate = orig["sim"]
        lstm_ops.lstm_seq = orig["lstm"]
    return remove


def capture_to_numpy(cap: dict) -> dict:
    """Stack each captured leaf over periods and move it to the host:
    ``group -> key -> (periods, k, ...)`` (``final``: ``(1, k, ...)``)."""
    return {g: {k: torch.stack(v).cpu().numpy() for k, v in rows.items()}
            for g, rows in cap.items()}


def _state(group: dict, t: int, i: int) -> dict:
    """One stream's queue state from a captured group, in the
    reference's layout and types."""
    st = {}
    for k in PRE_TRACE + ("nls", "jready", "missed", "done", "hit", "fjob",
                          "occupied", "rid"):
        st[k] = np.array(group[k][t, i])
    for k in ("arrival", "deadline", "q", "jready", "fjob"):
        st[k] = st[k].astype(np.float64)
    for k in ("model", "njl", "nls", "rid"):
        st[k] = st[k].astype(np.int64)
    st["sa_free"] = group["sa_free"][t, i].astype(np.float64)
    st["t"] = float(group["t"][t, i])
    st["energy"] = float(group["energy"][t, i])
    for k in ("admitted", "rejected", "counted", "hits"):
        st[k] = int(group[k][t, i])
    for k in ("ten_counted", "ten_hit"):
        st[k] = group[k][t, i].astype(np.int64)
    return st


def stream_ticks(cap: dict, i: int) -> list:
    """The program's periods of sampled stream ``i`` in the layout of
    ``reference.relmas.check_stream``."""
    T = cap["pre"]["nls"].shape[0]
    ticks = []
    for t in range(T):
        adm = {k: cap["adm"][k][t, i] for k in ADM}
        adm = {k: (v.astype(np.float64) if v.dtype.kind == "f" else v)
               for k, v in adm.items()}
        eng = {k: cap["eng"][k][t, i] for k in ENG + ("start", "finish")}
        out = {k: cap["out"][k][t, i] for k in OUT}
        out["finish_us"] = out["finish_us"].astype(np.float64)
        post = (_state(cap["pre"], t + 1, i) if t + 1 < T
                else _state(cap["final"], 0, i))
        ticks.append(dict(pre=_state(cap["pre"], t, i), adm=adm, eng=eng,
                          out=out, post=post))
    return ticks


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------
def check(pairs: list, weights: dict, tab: dict, env: dict, K: int,
          tol_us: float, control_device=None) -> dict:
    """Readings of the comparison over checked streams.  ``pairs``:
    ``(columns, ticks, completions, metrics)`` per stream.  With
    ``control_device``, the control is judged in the program's place
    (its periods from the program's start states)."""
    feats, masks = [], []
    for cols, ticks, _, _ in pairs:
        f, m = ref.reference_features(cols, ticks, tab, env, K)
        feats.append(f)
        masks.append(m)
    P = len(pairs[0][1])
    a_ref = ref.actor(weights, np.concatenate(feats), np.concatenate(masks))
    a_ctl = None
    if control_device is not None:
        a_ctl = ref.actor(weights, np.concatenate(feats),
                          np.concatenate(masks), "tf32", control_device)
    tl = ref.Tally(tol_us)
    for n, (cols, ticks, comp, met) in enumerate(pairs):
        a = a_ref[n * P:(n + 1) * P]
        if a_ctl is not None:
            ticks = ref.control_ticks(ticks, cols, a_ctl[n * P:(n + 1) * P],
                                      tab, env, K)
            comp = met = None
        ref.check_stream(tl, cols, ticks, comp, met, a, tab, env, K)
    out = tl.readings()
    out["notes"] = tl.notes
    out["compared"] = dict(sj=tl.sj[1], job=tl.job[1], streams=len(pairs))
    return out


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------
class Session:
    """The service and the tables of one configuration on one device,
    reused across seeds by the control script."""

    def __init__(self, config: dict, device: str):
        self.config = config
        self.device = device
        self.svc = build_service(config, device)
        self.tab = ref.prepare_tables(costmodel.tables(config))
        env = self.svc.env
        e = config["env"]
        self.env = dict(t_s_us=float(e["t_s_us"]), max_rq=e["max_rq"],
                        ttd_norm_periods=e["ttd_norm_periods"])
        self.horizon = env.cfg.horizon_us
        self.dims = (env.feat_dim, config["policy"]["hidden"], env.act_dim)
        self.policy = draw_weights(int(config["policy"]["policy_seed"]),
                                   *self.dims, device)
        self.rec = Recorder(device)
        self.remove = install(self.rec)

    def draw(self, seed: int, traffic: dict) -> dict:
        """The policy's weights in the seed's order (loaded into the
        program's actor) and the calls' streams and requests for
        ``seed``: one set, which every call of the run serves."""
        weights = permute_hidden(self.policy, seed)
        self.svc.actor.load_numpy(weights)
        cols = gen.call_streams(self.tab["min_lat"],
                                self.config["arrivals"], traffic,
                                self.horizon, seed, 0)
        return dict(weights=weights, cols=cols, seed=seed,
                    reqs=to_requests(cols, self.config["tenants"]["models"]),
                    S=int(traffic["streams"]),
                    k=int(traffic["check_streams_per_call"]))

    def warm_up(self, drawn: dict, K: int, ticks: int) -> None:
        """Serve the first ``ticks`` periods of the calls' streams, the
        requests that arrive in them: every operation of a period at the
        cell's shapes, without a check."""
        t_end = ticks * float(self.config["env"]["t_s_us"])
        reqs = [[r for r in st if r.arrival_us < t_end]
                for st in drawn["reqs"]]
        self.rec.begin_call(None)
        self.svc.serve_stream(reqs, tick_k=K, ticks=ticks)

    def serve(self, drawn: dict, c: int, K: int,
              capture: bool = True) -> dict:
        """Serve call ``c``, with its own sampled streams (none without
        ``capture``); returns what the check needs of it and the period
        times."""
        sample = (sample_streams(drawn["S"], drawn["k"], drawn["seed"], c)
                  if capture else None)
        self.rec.begin_call(sample)
        res = self.svc.serve_stream(drawn["reqs"], tick_k=K)
        t_end = time.perf_counter()
        keep = [] if sample is None else [int(s) for s in sample]
        return dict(sample=keep, t_end=t_end,
                    entries=list(self.rec.entries),
                    tick_s=list(self.rec.tick_s),
                    engine_s=list(self.rec.engine_s),
                    cap=self.rec.cap, cap_s=self.rec.cap_s,
                    completions=[res["completions"][s] for s in keep],
                    metrics=[res["metrics"][s] for s in keep],
                    unserved=res["stats"]["unserved"],
                    requests=sum(len(r) for r in drawn["reqs"]))

    def pairs(self, drawn: dict, calls: list, limit: int, seed: int):
        """The (columns, ticks, completions, metrics) of the checked
        streams: every sampled stream of the window's calls, or
        ``limit`` of them drawn from the seed."""
        cand = [(ci, n) for ci, call in enumerate(calls)
                for n in range(len(call["sample"]))]
        if len(cand) > limit:
            rng = np.random.default_rng([seed, 2 << 20])
            cand = [cand[i] for i in sorted(rng.choice(len(cand), limit,
                                                       replace=False))]
        out = []
        caps: dict = {}
        for ci, n in cand:
            call = calls[ci]
            if ci not in caps:
                caps[ci] = capture_to_numpy(call["cap"])
            cols = ref.stream_columns(drawn["cols"][call["sample"][n]])
            out.append((cols, stream_ticks(caps[ci], n),
                        call["completions"][n], call["metrics"][n]))
        return out


def periods_of(call: dict) -> list:
    ends = call["entries"][1:] + [call["t_end"]]
    return [b - a for a, b in zip(call["entries"], ends)]


def _events(prof):
    """Device operations and host ranges of a profile, as ``(name,
    start_s, end_s)``, and the count of device events by kind."""
    from torch.autograd import DeviceType
    evs = []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        evs.append(((e.name(), s, s + d),
                    e.device_type() == DeviceType.CUDA))
    return split_events(evs)


def split_events(evs):
    """``evs``: ``((name, start, end), on the device)``.  Device
    operations are the device's kernels, copies and sets; a range that
    ``record_function`` opened also shows on the device's timeline (a
    GPU user annotation) and is left out, because the host has a range
    of that name."""
    host = [x for x, on_dev in evs if not on_dev]
    names = {x[0] for x in host}
    dev, kinds = [], {}
    for x, on_dev in evs:
        if not on_dev:
            continue
        op = x[0] not in names
        kind = "operation" if op else "annotation"
        kinds[kind] = kinds.get(kind, 0) + 1
        if op:
            dev.append(x)
    return dev, host, kinds


def run(ctx, sess: Session | None = None) -> dict:
    """One run of a RELMAS cell; see ``portbench/run.py``.  ``sess``: a
    session of the cell's configuration to reuse (its weights and
    streams are drawn anew from ``ctx.seed``; no warm-up call)."""
    config, traffic, seed = ctx.config, ctx.traffic, ctx.seed
    K = int(traffic["tick_k"])
    warm = sess is None
    # set-up's parts, seconds since the process started (run.py)
    marks = dict(imports=time.perf_counter())
    if sess is None:
        sess = Session(config, ctx.device)
    marks["session"] = time.perf_counter()
    gc.disable()            # millions of request objects: no scans
    try:
        drawn = sess.draw(seed, traffic)
    finally:
        gc.enable()
    marks["draw"] = time.perf_counter()
    rec = sess.rec
    if warm:
        sess.warm_up(drawn, K, int(traffic["warm_up_ticks"]))
    rec.synchronize()
    marks["warm_up"] = time.perf_counter()
    # the window's collector scans what the program allocates, not the
    # requests that the benchmark keeps resident
    gc.collect()
    gc.freeze()
    prof_state: dict = {}
    p0, p1 = traffic["profile_ticks"]
    if ctx.trace:
        rec.sync = True

        def on_entry(i):
            if i == p0 and not prof_state:
                from torch.profiler import (ProfilerActivity, profile,
                                            record_function)
                rec.sync = False
                rec.count_actor = True
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
                rng = record_function("portbench.window")
                rng.__enter__()
                prof_state.update(prof=prof, rng=rng)
            elif i == p1 and "prof" in prof_state and "done" not in prof_state:
                prof_state["done"] = True
                prof_state["rng"].__exit__(None, None, None)
                prof_state["prof"].stop()
                rec.count_actor = False
                rec.sync = True
        rec.on_entry = on_entry

    t_win0 = time.perf_counter()
    calls = []
    while True:
        calls.append(sess.serve(drawn, len(calls), K, ctx.capture))
        rec.on_entry = None
        if calls[-1]["t_end"] - t_win0 >= ctx.seconds:
            break
    window_s = calls[-1]["t_end"] - t_win0
    setup_s = t_win0 - ctx.t_start
    gc.unfreeze()
    rec.sync = False
    peak = (torch.cuda.max_memory_allocated()
            if ctx.device != "cpu" else 0)
    S = int(traffic["streams"])
    periods = config["env"]["periods"]
    result = dict(
        attempted=sum(c["requests"] for c in calls),
        failed=sum(c["unserved"] for c in calls),
        memory_peak_bytes=int(peak), window_calls=len(calls),
        call_s=[c["t_end"] - c["entries"][0] for c in calls],
        capture_s=sum(c["cap_s"] for c in calls),
        setup_parts={k: v - ctx.t_start for k, v in marks.items()})
    lat = [p for c in calls for p in periods_of(c)]
    result["metrics"] = dict(
        periods_per_s=S * periods * len(calls) / window_s,
        tick_p95_ms=ys.percentile(lat, 95) * 1e3, setup_s=setup_s)
    if ctx.trace:
        result["data"] = trace_data(calls, prof_state, rec, p0, p1,
                                    sess.dims)
    rec.actor_calls = []
    if not ctx.capture:
        return result
    # the comparison, once the program's state is no longer needed
    pairs = sess.pairs(drawn, calls, int(traffic["check_pairs"]), seed)
    for c in calls:
        c["cap"] = None
    rec.cap = {}
    if warm:
        sess.remove()
        del sess.svc
        if ctx.device != "cpu":
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    result["readings"] = check(pairs, drawn["weights"], sess.tab, sess.env,
                               K, ctx.limits["tol_us"])
    result["check_s"] = time.perf_counter() - t0
    if ctx.control is not None:
        result["control_readings"] = check(
            pairs, drawn["weights"], sess.tab, sess.env, K,
            ctx.limits["tol_us"], control_device=ctx.control)
    return result


def trace_data(calls, prof_state, rec, p0, p1, dims) -> dict:
    """What the per-layer readers read: the synchronised period, tick
    and engine times outside the profiled periods, and the profile."""
    per, tick, eng = [], [], []
    for ci, c in enumerate(calls):
        skip = set(range(p0, p1 + 1)) if ci == 0 else set()
        for i, (p, ts, es) in enumerate(zip(periods_of(c), c["tick_s"],
                                            c["engine_s"])):
            if i in skip or ts is None or es is None:
                continue
            per.append(p)
            tick.append(ts)
            eng.append(es)
    data = dict(periods_s=per, tick_call_s=tick, engine_s=eng)
    if "done" not in prof_state:
        return data
    dev, host, kinds = _events(prof_state["prof"])
    win = [x for x in host if x[0] == "portbench.window"]
    lo, hi = (win[0][1], win[0][2]) if win else (
        min(x[1] for x in dev), max(x[2] for x in dev))
    F, H, G = dims
    calls_ = [(shape, h, int(live)) for shape, h, live in rec.actor_calls]
    data.update(device_events=dev, host_events=host, device_kinds=kinds,
                window=(lo, hi), window_s=hi - lo,
                profiled_periods=p1 - p0, actor_calls=calls_,
                feat=F, hidden=H, act_dim=G)
    return data
