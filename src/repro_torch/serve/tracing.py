"""Request-level tracing, step flight recorder, Perfetto export.

The survey's §4 loop (search → materialize → run) leaves the RUN half a
black box once the engine layers chunked prefill, speculation,
preemption and sharding on top of one traced program: aggregate
Prometheus summaries (serve/metrics.py) say THAT TTFT regressed, not
WHICH phase of WHICH step a given request spent its time in. This
module is the missing visibility layer, woven through the serve path by
PR 10 and deliberately dependency-free (stdlib only, like metrics.py):

  * **Per-request span trees** — every request accumulates typed events
    (``submitted``, ``admitted``, ``prefill_chunk``, ``decode``,
    ``first_token``, ``preempted``, ``expired``, ``completed``) stamped
    from the engine's existing lifecycle hooks, plus O(1) counters
    (generated tokens, prefill-chunk tokens, preemptions) that are
    default-on — the acceptance check "span tree matches the streamed
    token count" reads ``tokens`` straight off the trace.
  * **Per-step phase records** — :meth:`Tracer.begin_step` hands the
    engine a :class:`StepTrace` whose ``lap(phase)`` accumulates host
    wall time between call sites (draft / pack / dispatch / sync /
    bookkeeping...); the closed record also carries the step's work
    items (which slot decoded/prefilled what), so a step is attributable
    request by request. The driver drains per-step phase dicts into the
    ``serve_step_phase_seconds{phase=...}`` histograms.
  * **Flight recorder** — bounded ring buffers (``deque(maxlen=N)``) of
    the last N step records and recently finished request traces.
    :meth:`Tracer.flight` snapshots them on demand; the AsyncDriver's
    watchdog dumps the snapshot when a step overruns (replacing the
    PR 6 ad-hoc log dump), and ``GET /debug/flight`` serves it over
    HTTP — readable even while a stalled step holds the engine lock,
    because the tracer has its own tiny lock and the stalled thread is
    inside a device call, not inside the tracer.
  * **Chrome/Perfetto export** — :func:`chrome_trace` renders one or
    more tracers (one per DP replica) into the ``trace_event`` JSON
    object format: pid = replica, tid 0 = the engine-step lane (step
    spans with nested phase spans), tid 1+s = slot ``s``'s lane (one
    decode/prefill span per step, labeled with the rid and token
    counts). Load the file in https://ui.perfetto.dev or
    chrome://tracing. Request span trees ride in ``otherData``.

Overhead is bounded by construction: every hook is O(1) (append to a
ring or increment a counter), records live in fixed-size deques, and
``level`` gates the detail — 0 disables every hook (begin_step returns
the shared no-op :data:`NULL_STEP`), 1 (default) keeps lifecycle events
+ step records + counters, 2 adds a per-chunk / per-decode-step event to
the request span tree. Timestamps are ``time.perf_counter()`` — one
monotonic clock shared by every replica in the process, so merged lanes
line up.

Composition: a TP engine is still ONE engine → one tracer; a DP
``ReplicaRouter`` gives each replica its own tracer (``tracer.replica``
is stamped after construction) and merges them at export time —
per-lane ids never collide because the replica index is the pid.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

#: trace levels: OFF disables every hook, BASIC (default) records
#: lifecycle events + step records + per-request counters, DETAIL adds
#: per-chunk / per-decode-step events to the request span trees.
LEVEL_OFF, LEVEL_BASIC, LEVEL_DETAIL = 0, 1, 2


class _NullStep:
    """Shared no-op StepTrace stand-in for ``level=0`` — the engine's
    instrumentation calls land here branch-free."""

    __slots__ = ()

    def lap(self, phase: str):
        pass

    def note_decode(self, slot, rid, tokens, drafted=0, accepted=0):
        pass

    def note_chunk(self, slot, rid, start, count):
        pass


#: the singleton every disabled begin_step returns
NULL_STEP = _NullStep()


class StepTrace:
    """One engine step's record under construction (engine-thread local
    until :meth:`Tracer.end_step` publishes it into the ring).

    ``lap(phase)`` attributes the host time since the previous lap (or
    ``t0``) to ``phase``, accumulating on repeats — calling it at every
    section boundary partitions the step wall time with no gaps, which
    is what makes the exported phase spans cover ~100% of the step span
    (the acceptance bound is >= 95%)."""

    __slots__ = ("step_id", "t0", "_t", "dur", "produced", "phases",
                 "work")

    def __init__(self, step_id: int):
        self.step_id = step_id
        self.t0 = time.perf_counter()
        self._t = self.t0
        self.dur = 0.0
        self.produced = 0
        self.phases: Dict[str, float] = {}    # insertion-ordered laps
        self.work: List[dict] = []            # per-slot items this step

    def lap(self, phase: str):
        t = time.perf_counter()
        self.phases[phase] = self.phases.get(phase, 0.0) + (t - self._t)
        self._t = t

    def note_decode(self, slot: int, rid: int, tokens: int,
                    drafted: int = 0, accepted: int = 0):
        item = {"kind": "decode", "slot": int(slot), "rid": int(rid),
                "tokens": int(tokens)}
        if drafted:
            item["drafted"] = int(drafted)
            item["accepted_drafts"] = int(accepted)
        self.work.append(item)

    def note_chunk(self, slot: int, rid: int, start: int, count: int):
        self.work.append({"kind": "prefill", "slot": int(slot),
                          "rid": int(rid), "start": int(start),
                          "count": int(count)})

    def to_dict(self) -> dict:
        return {"step_id": self.step_id, "t0": self.t0, "dur": self.dur,
                "produced": self.produced,
                "phases": dict(self.phases), "work": list(self.work)}


class RequestTrace:
    """One request's span tree: typed events plus O(1) counters.

    ``tokens`` counts every generated token the engine appended to the
    request (prefill-sampled firsts included) — by construction it
    equals ``len(request.out)``, the streamed token count, which the
    tracing tests pin. ``events`` is bounded; overflow increments
    ``dropped`` instead of growing."""

    __slots__ = ("rid", "events", "tokens", "chunk_tokens",
                 "preemptions", "dropped", "max_events", "done",
                 "outcome")

    def __init__(self, rid: int, max_events: int = 256):
        self.rid = rid
        self.events: List[tuple] = []     # (t, kind, fields|None)
        self.tokens = 0
        self.chunk_tokens = 0
        self.preemptions = 0
        self.dropped = 0
        self.max_events = max_events
        self.done = False
        self.outcome: Optional[str] = None

    def add(self, kind: str, fields: Optional[dict]):
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append((time.perf_counter(), kind, fields))

    def to_dict(self) -> dict:
        return {
            "rid": self.rid, "tokens": self.tokens,
            "chunk_tokens": self.chunk_tokens,
            "preemptions": self.preemptions, "done": self.done,
            "outcome": self.outcome, "dropped_events": self.dropped,
            "events": [
                {"t": t, "kind": kind, **(fields or {})}
                for t, kind, fields in self.events]}


class Tracer:
    """The engine-side recorder: request span trees + step flight ring.

    One tracer per :class:`~repro_torch.serve.engine.ServeEngine` (a TP engine
    is still one engine); a DP router stamps each replica's
    ``tracer.replica`` after construction so merged exports get distinct
    pid lanes. Thread-safety: every mutation of the shared rings/maps
    happens under one small lock; a StepTrace is engine-thread-local
    until published. The HTTP/watchdog threads only ever read through
    :meth:`flight` / :func:`chrome_trace`, which snapshot under the same
    lock — safe to call while a stalled step holds the DRIVER lock,
    since the stalled thread is inside a device call, not in here."""

    def __init__(self, level: int = LEVEL_BASIC, *, max_steps: int = 256,
                 max_requests: int = 64, max_events: int = 256,
                 replica: int = 0):
        if max_steps < 1 or max_requests < 1 or max_events < 1:
            raise ValueError("tracer ring sizes must be >= 1")
        self.level = int(level)
        self.replica = int(replica)
        self.max_events = int(max_events)
        self._lock = threading.Lock()
        self.steps: Deque[StepTrace] = deque(maxlen=max_steps)
        self._live: Dict[int, RequestTrace] = {}
        self._done: Deque[RequestTrace] = deque(maxlen=max_requests)
        # per-step phase dicts awaiting the driver's histogram drain;
        # bounded so a batch run (no driver) cannot grow it
        self._pending: Deque[tuple] = deque(maxlen=max_steps)
        self.dropped_requests = 0

    @property
    def enabled(self) -> bool:
        return self.level >= LEVEL_BASIC

    # -------------------------------------------------------- step hooks
    def begin_step(self, step_id: int):
        """A fresh :class:`StepTrace` (or :data:`NULL_STEP` when
        disabled) — the engine laps phases on it and hands it back to
        :meth:`end_step`."""
        if self.level < LEVEL_BASIC:
            return NULL_STEP
        return StepTrace(step_id)

    def end_step(self, st, produced: int):
        """Publish a finished StepTrace into the flight ring (and the
        driver's pending-phases queue)."""
        if st is NULL_STEP or self.level < LEVEL_BASIC:
            return
        st.dur = time.perf_counter() - st.t0
        st.produced = int(produced)
        with self._lock:
            self.steps.append(st)
            self._pending.append((st.step_id, dict(st.phases), st.dur))

    def drain_phases(self) -> List[tuple]:
        """Pop every pending ``(step_id, phases, dur)`` triple — the
        driver observes them into ``serve_step_phase_seconds``."""
        with self._lock:
            out = list(self._pending)
            self._pending.clear()
        return out

    # ----------------------------------------------------- request hooks
    def _req(self, rid: int) -> RequestTrace:
        # caller holds the lock
        rt = self._live.get(rid)
        if rt is None:
            if len(self._live) >= 4096:      # runaway guard, not a limit
                self.dropped_requests += 1
                return RequestTrace(rid, max_events=1)
            rt = RequestTrace(rid, max_events=self.max_events)
            self._live[rid] = rt
        return rt

    def req_event(self, rid: int, kind: str, **fields):
        """Append a lifecycle event to ``rid``'s span tree (level >= 1)."""
        if self.level < LEVEL_BASIC:
            return
        with self._lock:
            self._req(rid).add(kind, fields or None)

    def req_detail(self, rid: int, kind: str, **fields):
        """Append a per-chunk / per-decode-step event (level >= 2 only —
        the O(step) detail the default level keeps out of the tree)."""
        if self.level < LEVEL_DETAIL:
            return
        with self._lock:
            self._req(rid).add(kind, fields or None)

    def req_tokens(self, rid: int, n: int):
        """Count ``n`` freshly generated tokens against ``rid``."""
        if self.level < LEVEL_BASIC:
            return
        with self._lock:
            self._req(rid).tokens += int(n)

    def req_chunk_tokens(self, rid: int, n: int):
        if self.level < LEVEL_BASIC:
            return
        with self._lock:
            self._req(rid).chunk_tokens += int(n)

    def req_preempted(self, rid: int, **fields):
        if self.level < LEVEL_BASIC:
            return
        with self._lock:
            rt = self._req(rid)
            rt.preemptions += 1
            rt.add("preempted", fields or None)

    def finish_request(self, rid: int, outcome: str, **fields):
        """Close ``rid``'s span tree (``completed`` or ``expired``) and
        move it from the live map to the finished ring."""
        if self.level < LEVEL_BASIC:
            return
        with self._lock:
            rt = self._live.pop(rid, None)
            if rt is None:
                rt = RequestTrace(rid, max_events=self.max_events)
            rt.add(outcome, fields or None)
            rt.done = True
            rt.outcome = outcome
            self._done.append(rt)

    def request_trace(self, rid: int) -> Optional[dict]:
        """The span tree for ``rid`` (live or recently finished)."""
        with self._lock:
            rt = self._live.get(rid)
            if rt is None:
                for cand in self._done:
                    if cand.rid == rid:
                        rt = cand
                        break
            return rt.to_dict() if rt is not None else None

    # ---------------------------------------------------- flight recorder
    def flight(self, last: Optional[int] = None) -> dict:
        """Snapshot of the ring buffers: the most recent ``last`` step
        records (all when None) plus live and recently finished request
        traces — the watchdog's dump and ``GET /debug/flight``."""
        with self._lock:
            steps = list(self.steps)
            live = [rt.to_dict() for rt in self._live.values()]
            done = [rt.to_dict() for rt in self._done]
        if last is not None:
            steps = steps[-last:]
        return {"replica": self.replica, "level": self.level,
                "steps": [st.to_dict() for st in steps],
                "live_requests": live, "finished_requests": done,
                "dropped_requests": self.dropped_requests}

    # ------------------------------------------------------------ export
    def export(self, path: str) -> dict:
        """Write this tracer's Chrome ``trace_event`` JSON to ``path``
        and return the object (see :func:`export_chrome_trace` for the
        multi-replica merge)."""
        return export_chrome_trace(path, [self])


# -------------------------------------------------- Chrome trace assembly
def _us(t: float) -> float:
    """perf_counter seconds -> trace_event microseconds."""
    return t * 1e6


def chrome_trace(tracers: Sequence[Tracer]) -> dict:
    """Merge one tracer per replica into one Chrome ``trace_event``
    object: ``{"traceEvents": [...], "otherData": {...}}``.

    Lanes: pid = the tracer's replica index (process rows in Perfetto),
    tid 0 = the engine-step lane — one complete ("X") span per step with
    its phase spans nested inside — and tid ``1 + slot`` = that slot's
    lane, one span per step describing the decode run or prefill chunk
    the slot performed (rid + token counts in ``args``). Per-lane
    timestamps are non-decreasing (step records are ring-ordered and a
    slot does at most one work item per step), which the CI trace-smoke
    job asserts. Request span trees ride in
    ``otherData["requests"]`` keyed by replica."""
    events: List[dict] = []
    requests: Dict[str, list] = {}
    for tr in tracers:
        snap = tr.flight()
        pid = snap["replica"]
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"replica {pid}"}})
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": "engine steps"}})
        slots_seen = set()
        for rec in snap["steps"]:
            ts0 = _us(rec["t0"])
            events.append({
                "name": f"step {rec['step_id']}", "cat": "step",
                "ph": "X", "ts": ts0, "dur": _us(rec["dur"]),
                "pid": pid, "tid": 0,
                "args": {"produced": rec["produced"],
                         "phases_s": rec["phases"]}})
            t = ts0
            for phase, sec in rec["phases"].items():
                events.append({
                    "name": phase, "cat": "phase", "ph": "X",
                    "ts": t, "dur": _us(sec), "pid": pid, "tid": 0,
                    "args": {}})
                t += _us(sec)
            for item in rec["work"]:
                s = item["slot"]
                slots_seen.add(s)
                if item["kind"] == "decode":
                    name = f"decode r{item['rid']}"
                    args = {k: item[k] for k in
                            ("rid", "tokens", "drafted",
                             "accepted_drafts") if k in item}
                else:
                    name = (f"prefill r{item['rid']} "
                            f"[{item['start']},"
                            f"{item['start'] + item['count']})")
                    args = {"rid": item["rid"], "start": item["start"],
                            "count": item["count"]}
                events.append({
                    "name": name, "cat": item["kind"], "ph": "X",
                    "ts": ts0, "dur": _us(rec["dur"]), "pid": pid,
                    "tid": 1 + s, "args": args})
        for s in sorted(slots_seen):
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": 1 + s,
                           "args": {"name": f"slot {s}"}})
        requests[str(pid)] = (snap["live_requests"]
                              + snap["finished_requests"])
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"clock": "perf_counter_us",
                          "requests": requests}}


def export_chrome_trace(path: str, tracers: Sequence[Tracer]) -> dict:
    """Serialize :func:`chrome_trace` of ``tracers`` to ``path``
    (Perfetto/chrome://tracing-loadable JSON); returns the object."""
    obj = chrome_trace(tracers)
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


def phase_coverage(tracers: Sequence[Tracer]) -> float:
    """Fraction of recorded step wall time the phase laps account for —
    1.0 when every section between begin_step and end_step was lapped
    (the acceptance bound is >= 0.95). NaN-free: 1.0 with no steps."""
    tot = cov = 0.0
    for tr in tracers:
        for rec in tr.flight()["steps"]:
            tot += rec["dur"]
            cov += sum(rec["phases"].values())
    return cov / tot if tot > 0 else 1.0
