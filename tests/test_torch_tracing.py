"""The port's tracing on its engine and driver (serve/tracing.py woven
through serve/engine.py, fed into serve/metrics.py by serve/driver.py,
served by serve/server.py), on the CPU.

The non-router cases of tests/test_serve_tracing.py on the port: span
trees whose token counts equal the streamed output across chunked
prefill and speculative decode, step phase laps covering >= 95% of the
step wall time on both paths, bounded rings, level 0 adding nothing and
level 2 adding detail (the tokens unchanged), a valid Chrome
``trace_event`` export, the driver's phase histogram, a render-vs-observe
hammer on every metric class, ``/healthz`` and ``/debug/*`` answering
while a stalled step holds the driver lock, and the overhead envelope of
tracing on vs off; and the dp 2 router's merged export
(tests/test_serve_tracing.py:238): one process lane a replica, each
request's spans in its home replica's lane only.
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serve.driver import AsyncDriver  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve.parallel import ReplicaRouter  # noqa: E402
from repro_torch.serve.scheduler import Priority  # noqa: E402
from repro_torch.serve.server import ServeHTTPServer  # noqa: E402
from repro_torch.serve.speculative import SpecConfig  # noqa: E402
from repro_torch.serve.tracing import (LEVEL_DETAIL, LEVEL_OFF,  # noqa: E402
                                       NULL_STEP, StepTrace, Tracer,
                                       phase_coverage)

#: tests/test_serve_tracing.py's CFG
KW = dict(name="trace-dense", arch_type="dense", num_layers=2, d_model=64,
          num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
          dtype="float32")
CFG = ModelConfig(**KW)
MIXED = dict(slots=2, max_len=64, paged=True, mixed=True, chunk_tokens=16)
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def params():
    jcfg = JaxConfig(**KW)
    return from_numpy(_flatten(get_model(jcfg).init(jax.random.key(0),
                                                    jcfg)), CFG, "cpu")


def _prompts(rng, lens):
    return [rng.integers(0, 128, size=(int(n),)).astype(np.int32)
            for n in lens]


def _run_engine(eng, prompts, max_new=6):
    for i, p in enumerate(prompts):
        eng.submit(i, p, max_new=max_new)
    return eng.run()


# ------------------------------------------------------------- unit level

def test_step_trace_laps_partition_wall_time():
    st = StepTrace(7)
    time.sleep(0.01)
    st.lap("pack")
    time.sleep(0.01)
    st.lap("dispatch")
    st.lap("pack")
    tr = Tracer()
    tr.end_step(st, produced=3)
    [rec] = tr.flight()["steps"]
    assert rec["step_id"] == 7 and rec["produced"] == 3
    assert set(rec["phases"]) == {"pack", "dispatch"}
    assert 0.95 * rec["dur"] <= sum(rec["phases"].values()) <= rec["dur"]


def test_tracer_rings_are_bounded():
    tr = Tracer(max_steps=4, max_requests=3, max_events=5)
    for i in range(10):
        tr.end_step(tr.begin_step(i), produced=0)
    assert [r["step_id"] for r in tr.flight()["steps"]] == [6, 7, 8, 9]
    for rid in range(9):
        tr.req_event(rid, "submitted")
        for _ in range(10):
            tr.req_event(rid, "noise")
        tr.finish_request(rid, "completed")
    snap = tr.flight()
    assert len(snap["finished_requests"]) == 3
    assert snap["finished_requests"][-1]["rid"] == 8
    assert all(r["dropped_events"] > 0 for r in snap["finished_requests"])
    assert len(tr.drain_phases()) == 4
    assert tr.drain_phases() == []


def test_level0_is_off_and_null_step_is_shared():
    tr = Tracer(level=LEVEL_OFF)
    assert not tr.enabled
    assert tr.begin_step(0) is NULL_STEP
    NULL_STEP.lap("x")
    NULL_STEP.note_decode(0, 0, 1)
    NULL_STEP.note_chunk(0, 0, 0, 4)
    tr.end_step(NULL_STEP, produced=5)
    tr.req_event(0, "submitted")
    tr.req_tokens(0, 3)
    tr.finish_request(0, "completed")
    snap = tr.flight()
    assert snap["steps"] == [] and snap["live_requests"] == [] \
        and snap["finished_requests"] == []


# -------------------------------------------------------- engine weaving

def test_span_tree_matches_streamed_token_count(params):
    """RequestTrace.tokens == len(request.out) for every request, across
    chunked prefill AND speculative decode."""
    rng = np.random.default_rng(0)
    motif = rng.integers(0, 128, size=(5,))
    prompts = _prompts(rng, (40, 6, 23)) + [np.tile(motif, 6)
                                            .astype(np.int32)]
    eng = ServeEngine(CFG, params, slots=2, max_len=96, paged=True,
                      mixed=True, chunk_tokens=16,
                      spec=SpecConfig(k=4, drafter="ngram"))
    results = _run_engine(eng, prompts, max_new=8)
    assert len(results) == len(prompts)
    assert eng.stats["spec_drafted"] > 0
    for rid, req in results.items():
        tree = eng.tracer.request_trace(rid)
        assert tree is not None and tree["done"]
        assert tree["outcome"] == "completed"
        assert tree["tokens"] == len(req.out)
        kinds = [e["kind"] for e in tree["events"]]
        assert kinds[0] == "submitted" and kinds[-1] == "completed"
        assert kinds.index("admitted") < kinds.index("first_token")
    for rid, p in enumerate(prompts):
        assert eng.tracer.request_trace(rid)["chunk_tokens"] == len(p)


def test_phase_coverage_and_step_accounting(params):
    prompts = _prompts(np.random.default_rng(1), (30, 5, 12))
    eng = ServeEngine(CFG, params, **MIXED)
    _run_engine(eng, prompts, max_new=6)
    assert phase_coverage([eng.tracer]) >= 0.95
    steps = eng.tracer.flight()["steps"]
    assert steps
    for rec in steps:
        assert sum(rec["phases"].values()) <= rec["dur"] + 1e-9
        assert set(rec["phases"]) <= {"bookkeeping", "draft", "pack",
                                      "dispatch", "sync"}
    assert sum(r["produced"] for r in steps) == eng.stats["decode_tokens"]


def test_legacy_path_is_traced_too(params):
    prompts = _prompts(np.random.default_rng(2), (9, 5))
    eng = ServeEngine(CFG, params, slots=2, max_len=64, paged=True,
                      mixed=False)
    results = _run_engine(eng, prompts, max_new=4)
    for rid, req in results.items():
        tree = eng.tracer.request_trace(rid)
        assert tree["tokens"] == len(req.out) and tree["done"]
    recs = eng.tracer.flight()["steps"]
    assert recs and all("dispatch" in r["phases"] for r in recs)
    assert phase_coverage([eng.tracer]) >= 0.95


def test_trace_level_2_adds_detail_and_level_0_adds_nothing(params):
    prompts = _prompts(np.random.default_rng(3), (25, 6))
    eng2 = ServeEngine(CFG, params, trace_level=LEVEL_DETAIL, **MIXED)
    res2 = _run_engine(eng2, prompts, max_new=4)
    kinds = [e["kind"] for e in eng2.tracer.request_trace(0)["events"]]
    assert "prefill_chunk" in kinds and "decode" in kinds
    eng0 = ServeEngine(CFG, params, trace_level=0, **MIXED)
    res0 = _run_engine(eng0, prompts, max_new=4)
    assert eng0.tracer.flight()["steps"] == []
    assert eng0.tracer.request_trace(0) is None
    assert {r: list(v.out) for r, v in res0.items()} \
        == {r: list(v.out) for r, v in res2.items()}


# ------------------------------------------------------------ export shape

def _lane_ts_monotonic(events):
    lanes = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        lane = (ev["pid"], ev["tid"], ev.get("cat"))
        assert ev["ts"] >= lanes.get(lane, float("-inf")), lane
        lanes[lane] = ev["ts"]
    return lanes


def test_chrome_export_is_valid_trace_event_json(params, tmp_path):
    prompts = _prompts(np.random.default_rng(4), (30, 5, 14))
    eng = ServeEngine(CFG, params, **MIXED)
    _run_engine(eng, prompts, max_new=5)
    path = tmp_path / "trace.json"
    obj = eng.export_trace(str(path))
    disk = json.loads(path.read_text())
    assert disk == obj
    evs = disk["traceEvents"]
    assert isinstance(evs, list) and evs
    for ev in evs:
        assert {"name", "ph", "pid", "tid"} <= set(ev)
        if ev["ph"] == "X":
            assert "ts" in ev and "dur" in ev and ev["dur"] >= 0
    assert _lane_ts_monotonic(evs)
    names = {e["name"] for e in evs}
    assert any(n.startswith("step ") for n in names)
    assert any(n.startswith(("decode r", "prefill r")) for n in names)
    assert {e["args"]["name"] for e in evs if e["name"] == "thread_name"} \
        >= {"engine steps", "slot 0"}
    assert set(disk["otherData"]["requests"]) == {"0"}
    assert {r["rid"] for r in disk["otherData"]["requests"]["0"]} \
        == set(range(len(prompts)))


# ------------------------------------------------- driver + metrics drain

def test_dp2_trace_merge_has_both_replica_lanes(params, tmp_path):
    """tests/test_serve_tracing.py:238 on the port: the router stamps
    each replica's tracer, its merged export has both lanes, each lane's
    spans in time order, each request's spans only in its home replica's
    lane, the request trees keyed by replica, and one flight snapshot a
    replica."""
    rng = np.random.default_rng(5)
    prompts = _prompts(rng, (18, 7, 22, 9, 13, 6))
    router = ReplicaRouter(CFG, params, dp=2, tp=1, devices=["cpu"] * 2,
                           **MIXED)
    assert [t.replica for t in router.tracers] == [0, 1]
    for i, p in enumerate(prompts):
        router.submit(i, p, max_new=4)
    router.run()
    path = tmp_path / "dp2.json"
    obj = router.export_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    assert {e["pid"] for e in evs if e["ph"] == "X"} == {0, 1}
    _lane_ts_monotonic(evs)
    for rid in range(len(prompts)):
        owning = {e["pid"] for e in evs if e["ph"] == "X"
                  and e.get("args", {}).get("rid") == rid}
        assert owning == {router.replica_of(rid)}
    assert set(obj["otherData"]["requests"]) == {"0", "1"}
    assert {e["pid"] for e in router.trace()["traceEvents"]
            if e["ph"] == "X"} == {0, 1}
    assert [f["replica"] for f in router.flight()["replicas"]] == [0, 1]


def test_driver_feeds_phase_histogram_and_render(params):
    prompts = _prompts(np.random.default_rng(6), (20, 6))
    eng = ServeEngine(CFG, params, **MIXED)
    drv = AsyncDriver(eng, start=False)
    streams = [drv.submit(p, max_new=4, rid=i)
               for i, p in enumerate(prompts)]
    drv.start()
    assert drv.join(timeout=TIMEOUT)
    drv.stop(drain=False, timeout=TIMEOUT)
    for s in streams:
        assert s.result(timeout=0.0).done
    hist = drv.metrics.step_phase
    assert {"dispatch", "pack", "sync"} <= set(hist.labels())
    assert hist.child("dispatch").count >= eng.stats["step_count"] > 0
    text = drv.render_metrics()
    assert text.count("# TYPE serve_step_phase_seconds summary") == 1
    assert 'serve_step_phase_seconds{phase="dispatch",quantile="0.5"}' \
        in text
    assert 'serve_step_phase_seconds_sum{phase="dispatch"}' in text
    assert 'serve_step_phase_seconds_count{phase="dispatch"}' in text
    h = drv.health()
    assert h["queue_depth"] == 0 and h["step_count"] > 0
    assert h["last_step_age_s"] is not None
    assert drv.flight()["replicas"][0]["steps"]
    assert drv.trace()["traceEvents"]


def test_metrics_render_hammer_under_concurrent_observes():
    reg = MetricsRegistry()
    h = reg.histogram("h_seconds", "plain", window=512)
    lh = reg.labeled_histogram("lh_seconds", "labeled", label="phase",
                               window=512)
    c = reg.counter("c_total")
    g = reg.gauge("g_now")
    stop = threading.Event()

    def pound():
        i = 0
        while not stop.is_set():
            h.observe(i % 7)
            lh.observe("a" if i % 2 else "b", i % 5)
            c.inc()
            g.set(i)
            i += 1

    threads = [threading.Thread(target=pound, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(300):
            for line in reg.render().splitlines():
                if line.startswith("#") or not line:
                    continue
                val = line.rsplit(" ", 1)[1]
                assert val == "NaN" or float(val) >= 0
        for _ in range(200):
            window, total, count = h.snapshot()
            assert len(window) <= 512
            assert count >= len(window)
            assert all(window[i] <= window[i + 1]
                       for i in range(len(window) - 1))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5.0)
    assert not any(t.is_alive() for t in threads)


# ------------------------------------------------------ HTTP observability

def test_healthz_and_debug_endpoints_respond_while_step_stalled(params):
    prompts = _prompts(np.random.default_rng(8), (6, 5, 7))
    eng = ServeEngine(CFG, params, **MIXED)
    eng.submit(100, prompts[0], max_new=2)
    eng.run()
    calls = {"n": 0}
    stalled = threading.Event()

    def step_fn(drv):
        calls["n"] += 1
        if calls["n"] >= 2:
            stalled.set()
            deadline = time.monotonic() + TIMEOUT
            while not drv.abort_step.is_set() and \
                    time.monotonic() < deadline:
                time.sleep(0.005)
            return
        drv.engine.step()

    drv = AsyncDriver(eng, step_fn=step_fn, start=False)
    server = ServeHTTPServer(drv, port=0)
    try:
        for i, p in enumerate(prompts):
            drv.submit(p, max_new=8, rid=i)
        drv.start()
        assert stalled.wait(timeout=30.0)
        time.sleep(0.05)

        def get(path):
            with urllib.request.urlopen(server.url + path,
                                        timeout=10) as r:
                return json.loads(r.read().decode())

        health = get("/healthz")
        assert health["status"] == "ok"
        assert health["step_in_flight_s"] > 0.0
        assert health["last_step_age_s"] > 0.0
        assert health["queue_depth"] >= 1
        assert health["step_count"] >= 1
        flight = get("/debug/flight")
        [rep] = flight["replicas"]
        assert rep["steps"]
        assert flight["snapshot"]["active"]
        assert get("/debug/trace")["traceEvents"]
    finally:
        drv.abort_step.set()
        server.close(drain=False)
        drv.stop(drain=False, timeout=TIMEOUT)
    assert not any(t.is_alive() for t in drv._threads)


def test_scheduler_explain_lands_on_submitted_event(params):
    eng = ServeEngine(CFG, params, slots=1, max_len=64, paged=True,
                      mixed=True, chunk_tokens=8, scheduler=Priority())
    eng.submit(0, np.arange(5, dtype=np.int32), max_new=2, priority=3)
    eng.run()
    sub = next(e for e in eng.tracer.request_trace(0)["events"]
               if e["kind"] == "submitted")
    assert sub["policy"] == "priority" and sub["priority"] == 3
    assert sub["prompt_tokens"] == 5


def test_tracing_overhead_within_bounds(params):
    """Tracing on vs off: identical outputs and a wide envelope on wall
    time (the reference's proxy for its 5% bench bound)."""
    prompts = _prompts(np.random.default_rng(9), (16, 8, 12, 6))

    def run(level):
        eng = ServeEngine(CFG, params, trace_level=level, **MIXED)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=6)
        t0 = time.perf_counter()
        res = eng.run()
        return time.perf_counter() - t0, \
            {r: list(v.out) for r, v in res.items()}

    run(1)
    run(0)
    t_on, out_on = run(1)
    t_off, out_off = run(0)
    assert out_on == out_off
    assert t_on < 3.0 * t_off + 0.25, (t_on, t_off)
