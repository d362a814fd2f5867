"""AsyncDriver: the online front of the serve engine — the port's copy of
``repro/serve/driver.py`` (it drives the port's ``ServeEngine`` through
the interface listed in ROADMAP.md, and over tensor-parallel ranks
broadcasts its host events with ``torch.distributed``).

Everything below ``ServeEngine.step`` is a batch machine: submit, then
``run()`` to drain. Real traffic is the opposite shape — requests arrive
at any time, want their tokens AS they are produced, and a hung step must
page somebody instead of hanging the process. This module owns that gap
(sglang's scheduler loop + watchdog are the exemplar):

  * the driver runs the engine's step loop on a BACKGROUND thread,
    sleeping on a condition variable while idle (an idle server burns no
    CPU) and stepping whenever any request is queued or mid-decode;
  * ``submit()`` is thread-safe, can be called at any time, and returns a
    :class:`TokenStream` — iterate it to receive the request's tokens as
    each engine step produces them; ``result()`` blocks for the full
    record. Greedy streamed output is BIT-IDENTICAL to what a batch
    ``run()`` over the same submissions returns (test-pinned, dense +
    tp-sharded + dp-routed);
  * per-request TTFT (submit -> first token) and TPOT (inter-token gap)
    land in a :class:`~repro_torch.serve.metrics.ServeMetrics` alongside
    per-step latency/occupancy — the numbers ``GET /metrics`` exposes
    and the DP router's tokens/s routing signal feeds from;
  * a WATCHDOG thread checks step wall time against
    ``watchdog_timeout``: an over-deadline step gets a diagnostic dump
    (queue depth, per-slot request/position table, allocator state —
    captured pre-step, so the dump never touches the engine mid-step)
    logged at ERROR, and when control returns to the loop every active
    slot is cancelled-and-requeued through the engine's EXISTING
    preemption path — partial outputs intact, greedy parity preserved by
    resume-by-re-prefill — instead of the stall wedging the slot table.

Locking: ONE lock serializes every engine touch (steps, submits, stats
reads). A lock is not fair, and the loop re-takes it right after each
step, so a caller from another thread (``submit``, ``stats``, ``join``)
is counted while it waits and the loop lets it in before the next step
(the reference's copy can starve such a caller for as long as the
engine stays busy). The watchdog never takes it — it reads the pre-step
snapshot and monotonic timestamps only, so a stalled step cannot stall
its own detection. Cancellation is cooperative: ``abort_step`` is set by
the watchdog; a single device program cannot observe it mid-flight
(device calls are uninterruptible), but the mixed-step engine polls it at
every CHUNK
boundary (the driver wires ``engine.abort_event`` to this event at
construction) and instrumented ``step_fn``s (tests inject stalls this
way) return early — recovery then lands at sub-step latency instead of
waiting out the full step.

The driver serves a single :class:`~repro_torch.serve.engine.ServeEngine` or
a :class:`~repro_torch.serve.parallel.ReplicaRouter` (``engines``)
identically (``step`` / ``busy`` / ``submit`` are the shared surface).
Construction normally goes through ``repro_torch.api.Session.
serve_async(...)`` or the HTTP layer in serve/server.py.

**Over tensor-parallel ranks** (an engine with ``tp > 1``, or a dp x tp
router: one process a rank, each with its own driver over its own
engine). The reference's driver runs one controller; here every rank's
host engine must step on the same submissions in the same order, while
``submit`` and the HTTP server live on rank 0 (the engine group's root;
the router's row 0 root, for the whole world). So rank 0 owns the loop
and every other rank is a follower: before each pass of the loop rank 0
broadcasts one batch of the host events gathered since the last pass, in
arrival order — "requeue every active slot" (the watchdog's recovery),
submissions (rid, prompt, ``max_new``, frames, images, priority and the
deadline's seconds left, counted from the request's arrival on rank 0),
records to forget, the pass's abort and "stop" — as one broadcast of its
length and one of the pickled bytes (``_Channel``; tallied as
``driver_events`` in the engine's ``rank.counts`` / ``rank.bytes``).
Every rank applies the batch in order, calls ``busy`` once (a world
all-reduce on a router) and steps when it is true. A follower decides
nothing: its ``submit`` raises, it runs no watchdog, and it leaves only
when rank 0's "stop" arrives. An idle rank 0 still sends an empty batch
every ``idle_wait_s``, so a follower never waits in a collective longer
than that plus one step. Rank 0's ``submit`` checks the request on the
host (``check_request``) and raises its ``ValueError`` at once, but only
queues the event: no engine call (each may be a collective) runs outside
a pass. On a router each other row's root sends rank 0 its requests' new
tokens and their done / expired state after every pass that stepped
(``driver_tokens``), so rank 0's streams carry every row's tokens.
``/metrics`` and ``stats`` read the engine stats the loop took after its
last stepped pass, ``busy`` the last pass's answer: no HTTP thread
issues a collective. One difference from the reference: the watchdog's
abort cannot cut a step short. The engine reads the abort fixed in the
batch (``abort_event`` is the pass's copy), so an abort raised mid-step
takes effect at the next pass boundary, where the batch also carries
the requeue; the streams stay the same. A fault in the loop (such as
the engine's check that the ranks packed the same program) ends the
loop on every rank that sees it, closes rank 0's streams with their
partial records and is kept in ``error``.
"""
from __future__ import annotations

import logging
import pickle
import queue as _queue
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

log = logging.getLogger("repro_torch.serve")

#: sentinel closing a TokenStream's queue
_DONE = object()


class TokenStream:
    """One request's live token feed.

    Iterating yields ints as the driver's step loop produces them and
    ends when the request completes; ``result()`` blocks until
    completion and returns the engine's full Request record (``out`` is
    the whole output, ``done`` distinguishes completion from a driver
    shutdown truncation). ``first_token_s`` is this request's TTFT once
    the first token exists (None before).
    """

    def __init__(self, rid: int):
        self.rid = rid
        self._q: _queue.Queue = _queue.Queue()
        self._done = threading.Event()
        self._record = None
        self.emitted = 0               # tokens pushed so far (driver-owned)
        self.first_token_s: Optional[float] = None

    # ------------------------------------------------------- driver side
    def _push(self, token: int):
        self.emitted += 1
        self._q.put(int(token))

    def _finish(self, record):
        self._record = record
        self._done.set()
        self._q.put(_DONE)

    # ------------------------------------------------------- caller side
    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _DONE:
                return
            yield item

    def tokens(self) -> List[int]:
        """Drain the stream to completion and return every token."""
        return list(self)

    def result(self, timeout: Optional[float] = None):
        """Block until the request completes; returns the Request record
        (its ``out`` holds the full output). Raises TimeoutError when
        ``timeout`` elapses first."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still running after "
                               f"{timeout}s")
        return self._record

    @property
    def done(self) -> bool:
        return self._done.is_set()


class _Channel:
    """The driver's control channel over tensor-parallel ranks: a picklable
    object from one rank to every rank of ``group`` (None: the world) as
    two broadcasts, its length and its bytes — only what ``core/tp.py``
    uses, so it runs with gloo and with NCCL. Over gloo the bytes stay on
    the host; NCCL takes them on ``device``. Each broadcast is tallied in
    ``rank.counts`` / ``rank.bytes`` under its label; ``passes`` and
    ``seconds`` count the event batches and the time spent in them."""

    def __init__(self, rank, group, src: int, device):
        self.rank, self.group, self.src = rank, group, src
        self.lead = dist.get_rank() == src
        self.device = torch.device("cpu") \
            if dist.get_backend(group) == "gloo" else torch.device(device)
        self.passes = 0
        self.seconds = 0.0

    def _broadcast(self, t: torch.Tensor, src: int, what: str):
        self.rank.tally(what, t)
        dist.broadcast(t, src=src, group=self.group)

    def send(self, obj, src: int, what: str):
        """``obj`` of rank ``src`` on every rank (the others pass None)."""
        data = pickle.dumps(obj) if dist.get_rank() == src else b""
        n = torch.tensor([len(data)], dtype=torch.int64, device=self.device)
        self._broadcast(n, src, what)
        size = int(n.item())
        buf = torch.zeros((max(size, 1),), dtype=torch.uint8,
                          device=self.device)
        if data:
            buf[:size] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        self._broadcast(buf, src, what)
        return pickle.loads(buf[:size].cpu().numpy().tobytes())

    def exchange(self, batch):
        """Rank 0's event batch on every rank (a follower passes None)."""
        t0 = time.perf_counter()
        batch = self.send(batch, self.src, "driver_events")
        self.seconds += time.perf_counter() - t0
        self.passes += 1
        return batch


def _channel(engine) -> Optional[_Channel]:
    """The control channel of a tensor-parallel engine (its "model"
    group, from its root) or dp x tp router (the world, from row 0's
    root); None for one process."""
    if getattr(engine, "tp", 1) <= 1:
        return None
    if hasattr(engine, "engines"):
        local = engine.engines[0]
        return _Channel(local._rank, None, engine.meshes[0][0], local.device)
    r = engine._rank
    return _Channel(r, r.group, r.root, engine.device)


class AsyncDriver:
    """Background step loop + per-request streaming + watchdog.

    Parameters
    ----------
    engine : ServeEngine | ReplicaRouter
        The machine to drive. The driver owns its step loop — do not call
        ``engine.step``/``run`` concurrently.
    watchdog_timeout : float | None
        Seconds a single step may take before the watchdog fires
        (diagnostic dump + cancel-and-requeue of every active slot once
        the step yields). None disables the watchdog thread.
    metrics : ServeMetrics | None
        Recording destination; a fresh one is built when omitted.
    start : bool
        Start the loop immediately. ``start=False`` lets a caller submit
        a whole batch first and then :meth:`start` — stepping then admits
        exactly like batch ``run()``, which the parity tests and the
        throughput bench use for determinism.
    step_fn : callable(driver) | None
        Override for one engine step (None -> ``engine.step()``). The
        instrumentation hook: tests inject stalls, a chunked step could
        poll ``driver.abort_step`` between chunks. Over tensor-parallel
        ranks each rank's driver calls its own, and each must run the
        engine's step whenever the pass has one.

    Over tensor-parallel ranks (see the module docstring) build one
    driver on every rank of the engine's group (the router's world) and
    start it on every rank: ``lead`` is True on rank 0, which takes the
    submissions; a follower's ``stop`` waits for rank 0's.
    """

    def __init__(self, engine, *, watchdog_timeout: Optional[float] = None,
                 metrics=None, start: bool = True, step_fn=None,
                 idle_wait_s: float = 0.2):
        from repro_torch.serve.metrics import ServeMetrics

        self.engine = engine
        self._chan = _channel(engine)
        self.lead = self._chan is None or self._chan.lead
        # rank 0's host events for the next pass, in arrival order
        self._pending: List[tuple] = []
        self._last_busy = False
        self._stats_snap: Optional[Dict] = None
        # the abort fixed in the pass's batch (what a tp engine reads)
        self._pass_abort = threading.Event()
        # a row root's tokens returned to rank 0 a rid, and the rids it
        # reported finished
        self._sent: Dict[int, int] = {}
        self._closed: set = set()
        self.error: Optional[BaseException] = None
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.watchdog_timeout = watchdog_timeout
        self._step_fn = step_fn
        self._idle_wait_s = idle_wait_s
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        # callers from other threads waiting for the lock; the loop lets
        # them in between steps
        self._waiting = 0
        self._waiting_lock = threading.Lock()
        self._streams: Dict[int, TokenStream] = {}
        self._requests: Dict[int, object] = {}    # rid -> Request record
        self._submit_t: Dict[int, float] = {}
        self._last_tok_t: Dict[int, float] = {}
        self._next_rid = 0
        self._stop_evt = threading.Event()
        self._started = False
        self._ended = threading.Event()          # the loop has returned
        # ---- watchdog channel (never lock-guarded: the watchdog must
        # stay responsive while a stalled step holds the lock)
        self.abort_step = threading.Event()
        self._stall_fired = threading.Event()
        self._step_t0: Optional[float] = None
        self._last_step_done: Optional[float] = None
        self._snapshot: Dict = {}
        self._threads: List[threading.Thread] = []
        # chunk-boundary cancellation: a mixed-step engine polls this
        # event at the top of each step and skips launching its program
        # while set, so watchdog recovery lands at sub-step latency; over
        # ranks it reads the pass's copy, the same on every rank
        for e in self._engines():
            if hasattr(e, "abort_event"):
                e.abort_event = self.abort_step if self._chan is None \
                    else self._pass_abort
        # previous engine-counter readings for per-step chunk telemetry
        self._prev_pf_tokens = 0
        self._prev_decode_tokens = 0
        # ... and for speculative-decode telemetry (independent set so
        # the two observers never couple through a shared counter)
        self._prev_spec = {"spec_drafted": 0, "spec_accepted": 0,
                           "decode_tokens": 0, "prefills": 0,
                           "decode_slot_steps": 0}
        if start:
            self.start()

    @contextmanager
    def _locked(self):
        """The engine lock for a caller outside the step loop, counted
        while it waits so the loop yields it between steps."""
        with self._waiting_lock:
            self._waiting += 1
        self._lock.acquire()
        with self._waiting_lock:
            self._waiting -= 1
        try:
            yield
        finally:
            self._lock.release()

    # ----------------------------------------------------------- control
    def start(self):
        """Launch the loop (and watchdog) threads; idempotent."""
        with self._lock:
            if self._started:
                return self
            self._started = True
        t = threading.Thread(
            target=self._loop if self._chan is None else self._rank_loop,
            name="serve-driver", daemon=True)
        t.start()
        self._threads = [t]
        if self.watchdog_timeout is not None and self.lead:
            w = threading.Thread(target=self._watchdog_loop,
                                 name="serve-watchdog", daemon=True)
            w.start()
            self._threads.append(w)
        return self

    def stop(self, wait: bool = True, drain: bool = True,
             timeout: float = 30.0):
        """Shut the loop down. ``drain=True`` (default) keeps stepping
        until in-flight requests finish first; ``drain=False`` stops at
        the next step boundary and closes open streams with their
        partial records (``done=False``). Over tensor-parallel ranks
        rank 0 sends "stop" to every rank at that pass; a follower's
        ``stop`` waits for it (``wait``)."""
        if not self.lead:
            if wait:
                self.wait()
            return
        if drain and self._started:
            self.join(timeout=timeout)
        self._stop_evt.set()
        with self._wake:
            self._wake.notify_all()
        if wait:
            for t in self._threads:
                t.join(timeout=timeout)
        with self._lock:
            self._close_streams()

    def _close_streams(self):
        for rid, stream in list(self._streams.items()):
            stream._finish(self._requests.get(rid))
        self._streams.clear()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the loop has ended (a follower's: until rank 0's
        "stop" arrived); True when it has, or when it never started. A
        ctrl-c reaches the caller and leaves the loop running."""
        if not self._started:
            return True
        return self._ended.wait(timeout)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request has completed (True) or
        ``timeout`` elapsed (False). The loop keeps running."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._locked():
                if not self._streams:
                    return True
                stream = next(iter(self._streams.values()))
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            if left == 0.0:
                return False
            try:
                stream.result(left)
            except TimeoutError:
                return False

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=not any(exc))

    # ------------------------------------------------------------ submit
    def submit(self, prompt, max_new: int = 16, *, rid: Optional[int] = None,
               frames=None, images=None, priority: int = 0,
               deadline_s: Optional[float] = None) -> TokenStream:
        """Thread-safe submission; returns the request's TokenStream.
        Validation failures (bad prompt/pool bounds) raise the engine's
        ValueError synchronously — nothing is enqueued. ``deadline_s``
        declares an SLO (see ServeEngine.submit): an expired-while-queued
        request's stream closes with ``done=False, expired=True``.
        Over tensor-parallel ranks only rank 0 takes submissions: the
        request is checked here and reaches every rank's engine at the
        next pass."""
        if not self.lead:
            raise RuntimeError(
                f"submit on rank {self._chan.src}: rank {dist.get_rank()} "
                "follows rank 0's events")
        if self._stop_evt.is_set():
            raise RuntimeError("driver is stopped")
        t_submit = time.monotonic()
        with self._locked():
            if rid is None:
                rid = self._next_rid
            elif rid in self._streams:
                raise ValueError(f"request {rid} already in flight")
            self._next_rid = max(self._next_rid, rid + 1)
            if self._chan is None:
                req = self._engine_submit(
                    rid, prompt, max_new, frames=frames, images=images,
                    priority=priority, deadline_s=deadline_s)
            else:
                req = self._enqueue(rid, prompt, max_new, frames, images,
                                    priority, deadline_s, t_submit)
            stream = TokenStream(rid)
            self._streams[rid] = stream
            self._requests[rid] = req
            self._submit_t[rid] = t_submit
            self.metrics.submitted.inc()
            self._wake.notify_all()
        return stream

    def _engine_submit(self, rid, prompt, max_new, *, frames, priority,
                       images=None, deadline_s=None):
        """Submit to either backend and return the Request record (None
        for a request another rank's replica took)."""
        ret = self.engine.submit(rid, prompt, max_new, frames=frames,
                                 images=images, priority=priority,
                                 deadline_s=deadline_s)
        if isinstance(ret, int):       # ReplicaRouter returns the replica
            replicas = self.engine._replicas()
            if ret not in replicas:
                return None
            return self.engine.engines[replicas.index(ret)].queue[-1]
        return ret

    def _enqueue(self, rid, prompt, max_new, frames, images, priority,
                 deadline_s, t_submit):
        """Rank 0: check a request on the host and queue it for the next
        pass; returns its record until the engine's replaces it (kept,
        and fed by the row roots' returns, where another row serves
        it)."""
        from repro_torch.serve.engine import Request
        prompt, frames, images, _ = self._engines()[0].check_request(
            rid, prompt, max_new, frames=frames, images=images,
            deadline_s=deadline_s)
        self._pending.append(("submit", rid, prompt, int(max_new), frames,
                              images, int(priority), deadline_s, t_submit))
        return Request(rid, prompt, int(max_new), frames=frames,
                       images=images, priority=int(priority))

    # ----------------------------------------------------------- metrics
    def _engines(self) -> List:
        return list(getattr(self.engine, "engines", [self.engine]))

    def stats(self) -> Dict:
        """The backend's stats dict (router: aggregated), lock-guarded;
        over ranks the loop's copy after its last stepped pass (empty
        before the first pass)."""
        if self._chan is not None:
            return dict(self._stats_snap or {})
        with self._locked():
            return dict(self.engine.stats)

    def busy(self) -> bool:
        """Whether a request is queued or in a slot; over ranks the last
        pass's answer (the router's is a collective only the loop
        calls)."""
        return self._last_busy if self._chan is not None else self._busy()

    def render_metrics(self) -> str:
        """Prometheus text: driver latency metrics + engine telemetry."""
        return self.metrics.render(extra=self.stats())

    # ---------------------------------------- observability (lock-free)
    # None of these take the driver lock: a load balancer probing
    # /healthz or an operator pulling /debug/flight must get an answer
    # even while a stalled step holds the lock. Reads are monotonic
    # timestamps, deque lengths, and tracer state (its own small lock).

    def health(self) -> Dict:
        """Liveness + progress signals for ``GET /healthz``: a wedged-
        but-alive engine shows a growing ``last_step_age_s`` while
        ``queue_depth`` piles up."""
        now = time.monotonic()
        done = self._last_step_done
        t0 = self._step_t0
        return {
            "ok": True,
            "queue_depth": sum(len(e.queue) for e in self._engines()),
            "step_count": sum(e.stats["step_count"]
                              for e in self._engines()),
            "last_step_age_s": None if done is None else now - done,
            "step_in_flight_s": None if t0 is None else now - t0,
            "watchdog_fired": self._stall_fired.is_set(),
        }

    def flight(self, last: Optional[int] = None) -> Dict:
        """Flight-recorder snapshot: per-replica step-record rings and
        request spans plus the watchdog's pre-step snapshot."""
        now = time.monotonic()
        done = self._last_step_done
        return {
            "last_step_age_s": None if done is None else now - done,
            "snapshot": dict(self._snapshot),
            "replicas": [e.tracer.flight(last) for e in self._engines()
                         if getattr(e, "tracer", None) is not None],
        }

    def trace(self) -> Dict:
        """Merged Chrome ``trace_event`` JSON object across replicas."""
        from repro_torch.serve.tracing import chrome_trace
        return chrome_trace([e.tracer for e in self._engines()
                             if getattr(e, "tracer", None) is not None])

    def export_trace(self, path: str) -> Dict:
        """Write the merged Chrome/Perfetto trace JSON to ``path``."""
        from repro_torch.serve.tracing import export_chrome_trace
        return export_chrome_trace(
            path, [e.tracer for e in self._engines()
                   if getattr(e, "tracer", None) is not None])

    # ------------------------------------------------------------- loop
    def _busy(self) -> bool:
        # a router's busy spans every replica (over ranks, a world
        # all-reduce)
        return bool(self.engine.busy())

    def _take_snapshot(self):
        """Pre-step state for the watchdog's diagnostic dump — captured
        under the lock so the dump itself never touches the engine."""
        snap = {"queue_depth": 0, "active": [], "pools": [],
                # the id the in-flight step WILL get (engines stamp
                # begin_step with the pre-increment step_count), so the
                # stall report can name the stalled step
                "step_ids": [e.stats["step_count"]
                             for e in self._engines()]}
        for i, e in enumerate(self._engines()):
            snap["queue_depth"] += len(e.queue)
            for s, req in enumerate(e.active):
                if req is not None:
                    snap["active"].append(
                        {"replica": i, "slot": s, "rid": req.rid,
                         "pos": int(e._pos[s]), "out": len(req.out)})
            if e.paged:
                snap["pools"].append(
                    {"replica": i, "free_pages": e._alloc.free_pages,
                     "pages_in_use": e._alloc.pages_in_use})
        self._snapshot = snap

    def _loop(self):
        try:
            self._step_loop()
        finally:
            self._ended.set()

    def _step_loop(self):
        while not self._stop_evt.is_set():
            with self._wake:
                while not self._busy() and not self._stop_evt.is_set():
                    self._wake.wait(self._idle_wait_s)
                if self._stop_evt.is_set():
                    return
                self._step_once()
            while self._waiting and not self._stop_evt.is_set():
                time.sleep(1e-4)             # let a waiting caller in

    # ------------------------------------------------- loop over ranks
    def _rank_loop(self):
        """The loop over tensor-parallel ranks: rank 0 takes a batch of
        its host events, every rank receives it and runs the pass; a
        fault ends the loop (kept in ``error``) and closes the
        streams."""
        try:
            while True:
                batch = self._take_batch() if self.lead else None
                batch = self._chan.exchange(batch)
                with self._lock:
                    if self._pass(batch):
                        return
                while self._waiting and not self._stop_evt.is_set():
                    time.sleep(1e-4)         # let a waiting caller in
        except BaseException as exc:
            self.error = exc
            log.error("serve driver: the loop on rank %d ended: %r",
                      dist.get_rank(), exc)
            self._stop_evt.set()
            with self._lock:
                self._close_streams()
        finally:
            self._ended.set()

    def _take_batch(self) -> Dict:
        """Rank 0: wait (at most ``idle_wait_s`` while idle) and take the
        events since the last pass; a deadline becomes the seconds left
        of it now (at least 1 us: an overdue request expires at the next
        step, on every rank)."""
        with self._wake:
            if not (self._pending or self._last_busy
                    or self._stop_evt.is_set()
                    or self._stall_fired.is_set()):
                self._wake.wait(self._idle_wait_s)
            now = time.monotonic()
            events = []
            for ev in self._pending:
                if ev[0] == "submit":
                    *head, deadline_s, t_submit = ev
                    left = None if deadline_s is None else \
                        max(deadline_s - (now - t_submit), 1e-6)
                    ev = (*head, left)
                events.append(ev)
            self._pending = []
            requeue = self._stall_fired.is_set()
            return {"requeue": requeue, "events": events,
                    "abort": self.abort_step.is_set() and not requeue,
                    "stop": self._stop_evt.is_set()}

    def _pass(self, batch: Dict) -> bool:
        """One pass on every rank, under the lock: the watchdog's
        requeue, the events in order, then (unless "stop": True is
        returned) one ``busy`` and, while busy, one step."""
        if batch["requeue"]:
            self._recover()
        for ev in batch["events"]:
            if ev[0] == "submit":
                _, rid, prompt, max_new, frames, images, prio, left = ev
                req = self._engine_submit(
                    rid, prompt, max_new, frames=frames, images=images,
                    priority=prio, deadline_s=left)
                if self.lead and req is not None:
                    self._requests[rid] = req
            else:                                    # ("forget", rid)
                self._forget_now(ev[1])
        if batch["stop"]:
            return True
        if batch["abort"]:
            self._pass_abort.set()
        else:
            self._pass_abort.clear()
        self._last_busy = self._busy()
        if self._last_busy:
            self._step_once()
        elif self._stats_snap is None:
            self._stats_snap = dict(self.engine.stats)
        return False

    def _row_returns(self):
        """Router over ranks, after a stepped pass: each other row's root
        sends rank 0 its requests' new tokens and finished states (every
        process takes part); rank 0 extends the records it keeps for
        them."""
        router = self.engine
        for ranks in router.meshes:
            root = ranks[0]
            if root == self._chan.src:
                continue                  # rank 0 reads its own replica
            mine = self._fresh_tokens() \
                if dist.get_rank() == root else None
            for rid, fresh, done, expired in self._chan.send(
                    mine, root, "driver_tokens"):
                req = self._requests.get(rid) if self.lead else None
                if req is not None:
                    req.out.extend(fresh)
                    req.done, req.expired = done, expired

    def _fresh_tokens(self) -> List[tuple]:
        """A row root's (rid, new tokens, done, expired) of each of its
        requests that changed since its last return."""
        out = []
        for rid, req in self.engine.engines[0].results().items():
            if rid in self._closed:
                continue
            sent = self._sent.get(rid, 0)
            fresh = [int(t) for t in req.out[sent:]]
            if fresh or req.done or req.expired:
                out.append((rid, fresh, bool(req.done), bool(req.expired)))
                self._sent[rid] = len(req.out)
                if req.done or req.expired:
                    self._closed.add(rid)
        return out

    def _step_once(self):
        """One engine step under the lock: snapshot, step (watchdog-
        timed), recover if the watchdog fired (over ranks: at the next
        pass, from its batch), then stream fresh tokens and record
        latencies."""
        self._take_snapshot()
        occupancy = len(self._snapshot["active"])
        self.metrics.occupancy.observe(occupancy)
        t0 = time.monotonic()
        self._step_t0 = t0
        try:
            if self._step_fn is not None:
                self._step_fn(self)
            else:
                self.engine.step()
        finally:
            self._step_t0 = None
        now = time.monotonic()
        self._last_step_done = now
        self.metrics.step_latency.observe(now - t0)
        if self._stall_fired.is_set() and self._chan is None:
            self._recover()
        # one read a step (a world collective on a router over ranks),
        # kept for stats() there
        st = dict(self.engine.stats)
        if self._chan is not None:
            self._stats_snap = st
        self._observe_chunking(st)
        self._observe_spec(st)
        self._drain_phases()
        if self._chan is not None and hasattr(self.engine, "engines"):
            self._row_returns()
        self._drain_tokens(now)
        self.metrics.queue_depth.set(
            sum(len(e.queue) for e in self._engines()))
        self.metrics.active_slots.set(
            sum(sum(r is not None for r in e.active)
                for e in self._engines()))

    def _observe_chunking(self, st: Dict):
        """Per-step mixed-batch telemetry: how many prefill-chunk tokens
        the step processed and what fraction of its work was prefill —
        counter DELTAS against the previous reading, clamped at zero so
        an ``engine.reset_stats()`` mid-flight resynchronizes instead of
        feeding negative samples."""
        if not any(getattr(e, "mixed", False) for e in self._engines()):
            return
        pf, dec = st.get("prefill_chunk_tokens", 0), st["decode_tokens"]
        dpf = max(0, pf - self._prev_pf_tokens)
        ddec = max(0, dec - self._prev_decode_tokens)
        self._prev_pf_tokens, self._prev_decode_tokens = pf, dec
        if dpf + ddec > 0:
            self.metrics.prefill_chunk.observe(dpf)
            self.metrics.prefill_frac.observe(dpf / (dpf + ddec))

    def _observe_spec(self, st: Dict):
        """Speculative-decode telemetry (same delta-vs-previous pattern
        as :meth:`_observe_chunking`, its own counter set): export the
        drafted/accepted totals, the cumulative accept-rate gauge, and a
        tokens-per-decode-slot-step sample — decode tokens MINUS
        prefill-sampled first tokens over the step's (step, decoding
        slot) pair count, exactly 1.0 without speculation regardless of
        occupancy, so the >1.0 signal isolates what speculation bought."""
        if not any(getattr(e, "spec", None) is not None
                   for e in self._engines()):
            return
        cur = {k: st.get(k, 0) for k in self._prev_spec}
        d = {k: max(0, cur[k] - self._prev_spec[k]) for k in cur}
        self._prev_spec = cur
        if d["spec_drafted"]:
            self.metrics.spec_drafted.inc(d["spec_drafted"])
        if d["spec_accepted"]:
            self.metrics.spec_accepted.inc(d["spec_accepted"])
        if cur["spec_drafted"] > 0:
            self.metrics.spec_accept_rate.set(
                cur["spec_accepted"] / cur["spec_drafted"])
        if d["decode_slot_steps"] >= 1:
            self.metrics.spec_tokens_per_step.observe(
                (d["decode_tokens"] - d["prefills"])
                / d["decode_slot_steps"])

    def _drain_phases(self):
        """Feed every engine's pending per-step phase timings into the
        ``serve_step_phase_seconds{phase=...}`` histogram (the tracer's
        pending deque decouples engine stepping from metric export)."""
        for e in self._engines():
            t = getattr(e, "tracer", None)
            if t is None:
                continue
            for _sid, phases, _dur in t.drain_phases():
                for ph, sec in phases.items():
                    self.metrics.step_phase.observe(ph, sec)

    def _drain_tokens(self, now: float):
        """Push every token the last step appended to its stream and
        record TTFT/TPOT; close out completed (or deadline-expired)
        requests."""
        for rid, stream in list(self._streams.items()):
            req = self._requests[rid]
            fresh = len(req.out) - stream.emitted
            if fresh > 0:
                # a step may append several tokens per request (catch-up
                # after deferred start, speculative accepts); spreading
                # the interval evenly across them keeps TPOT truthful —
                # the wall time really was shared by the whole group
                gap = now - self._last_tok_t.get(
                    rid, self._submit_t[rid])
                for _ in range(fresh):
                    if stream.emitted == 0:
                        # the engine stamps the first token's host time
                        # at prefill completion, so TTFT is correct even
                        # for requests that finish AT admission (the
                        # stream drains them on the same loop pass)
                        ft = getattr(req, "first_tok_t", None)
                        stream.first_token_s = \
                            (ft if ft is not None else now) \
                            - self._submit_t[rid]
                        self.metrics.ttft.observe(stream.first_token_s)
                    else:
                        self.metrics.tpot.observe(gap / fresh)
                    stream._push(req.out[stream.emitted])
                self._last_tok_t[rid] = now
                self.metrics.tokens.inc(fresh)
            expired = getattr(req, "expired", False)
            if req.done or expired:
                if req.done:
                    self.metrics.completed.inc()
                    self.metrics.e2e.observe(now - self._submit_t[rid])
                else:
                    self.metrics.expired.inc()
                stream._finish(req)
                del self._streams[rid]
                self._requests.pop(rid, None)
                self._submit_t.pop(rid, None)
                self._last_tok_t.pop(rid, None)
                self._forget(rid)

    def _forget(self, rid: int):
        """Drop the engine's finished record (the stream owns it now) so
        a long-lived server's ``finished`` dict stays bounded; over ranks
        every rank drops it at the next pass."""
        if self._chan is None:
            self._forget_now(rid)
        else:
            self._pending.append(("forget", rid))

    def _forget_now(self, rid: int):
        for e in self._engines():
            e.finished.pop(rid, None)
        for book in (getattr(self.engine, "_home", None),
                     getattr(self.engine, "_subs", None), self._sent):
            if book is not None:
                book.pop(rid, None)
        self._closed.discard(rid)

    # ---------------------------------------------------------- watchdog
    def _watchdog_loop(self):
        interval = max(self.watchdog_timeout / 4.0, 0.01)
        while not self._stop_evt.wait(interval):
            t0 = self._step_t0
            if t0 is None or self._stall_fired.is_set():
                continue
            overrun = time.monotonic() - t0
            if overrun > self.watchdog_timeout:
                self.metrics.watchdog_fired.inc()
                log.error(self._stall_report(overrun))
                self._stall_fired.set()
                self.abort_step.set()

    def _stall_report(self, overrun: float) -> str:
        """Flight-recorder dump for a fired watchdog: names the stalled
        step id(s), every active slot, pool occupancy, and the tail of
        the step-record ring. Lock-free by construction — the pre-step
        snapshot plus tracer reads (the tracer has its OWN lock; the
        stalled thread is inside a device call, not inside the tracer)."""
        snap = self._snapshot
        sid = "/".join(str(i) for i in snap.get("step_ids", [])) or "?"
        lines = [f"serve watchdog: step {sid} stalled {overrun:.2f}s "
                 f"(timeout {self.watchdog_timeout}s); "
                 f"queue_depth={snap.get('queue_depth', 0)}"]
        for row in snap.get("active", []):
            lines.append(
                "  slot r{replica}/s{slot}: rid={rid} pos={pos} "
                "out={out}".format(**row))
        for pool in snap.get("pools", []):
            lines.append(
                "  pool r{replica}: {pages_in_use} pages in use, "
                "{free_pages} free".format(**pool))
        for i, e in enumerate(self._engines()):
            t = getattr(e, "tracer", None)
            if t is None or not t.enabled:
                continue
            for rec in t.flight(last=3)["steps"]:
                ph = " ".join(f"{k}={v * 1e3:.2f}ms"
                              for k, v in rec["phases"].items())
                lines.append(
                    f"  flight r{i} step {rec['step_id']}: "
                    f"dur={rec['dur'] * 1e3:.2f}ms "
                    f"produced={rec['produced']} {ph}")
        lines.append("  recovery: cancel-and-requeue every active slot "
                     "via the preemption path once the step yields")
        return "\n".join(lines)

    def _recover(self):
        """Post-stall recovery (loop thread, lock held): requeue every
        active request through the engine's preemption path. Partial
        outputs ride along; re-admission re-prefills prompt+output, so
        greedy token streams resume bit-identically."""
        requeued = 0
        for e in self._engines():
            for s in range(e.slots):
                if e.active[s] is not None:
                    e.preempt(s)
                    requeued += 1
        if requeued:
            self.metrics.watchdog_requeued.inc(requeued)
        log.error("serve watchdog: requeued %d active request(s) after "
                  "stalled step", requeued)
        self._stall_fired.clear()
        self.abort_step.clear()
