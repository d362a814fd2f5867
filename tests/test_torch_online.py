"""The port's online stack on the CPU: serve/metrics.py, driver.py and
server.py over the port's ``ServeEngine``, and ``Session.serve_async`` /
``serve_http`` / ``save`` / ``restore``.

The dense cases of tests/test_serve_online.py (the dp 2 router's in one
process, ``serve/parallel.py``), the driver's
abort recovery (tests/test_serve_mixed.py:341), the driver's speculative
metrics (tests/test_serve_spec.py:274) and the Session checkpoint round
trip (tests/test_api_session.py:104), each on the port: quantile and
histogram edge cases; every Prometheus metric name of the reference
kept; the driver's streamed greedy output equal to a batch ``run()`` and
to the JAX engine's; live submission; the watchdog recovering an injected
stall through the engine's preemption path; HTTP over a real socket
(``/generate`` JSON and chunked streaming, ``/metrics``, ``/healthz``,
400s, 404, and 504 on a wedged engine). Every join, wait and socket has
a timeout.
"""
import json
import logging
import math
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.serve import metrics as jax_metrics  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serve.driver import AsyncDriver  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.metrics import (  # noqa: E402
    Histogram, MetricsRegistry, ServeMetrics, quantile)
from repro_torch.serve.parallel import ReplicaRouter  # noqa: E402
from repro_torch.serve.server import ServeHTTPServer, serve_http  # noqa: E402
from repro_torch.serve.speculative import SpecConfig  # noqa: E402
from repro_torch.train.trainer import TrainConfig  # noqa: E402

#: tests/test_serve_online.py's CFG
KW = dict(name="online-dense", arch_type="dense", num_layers=2, d_model=64,
          num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
          dtype="float32")
CFG = ModelConfig(**KW)
ENG = dict(slots=2, max_len=64, paged=True)
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def weights():
    """JAX params and their bridge into the port (CPU)."""
    jcfg = JaxConfig(**KW)
    jp = get_model(jcfg).init(jax.random.key(0), jcfg)
    return jcfg, jp, from_numpy(_flatten(jp), CFG, "cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=(int(n),)).astype(np.int32)
            for n in lens]


def _batch(engine, prompts, new):
    for i, p in enumerate(prompts):
        engine.submit(i, p, max_new=new)
    res = engine.run()
    return {i: list(res[i].out) for i in res}


def _driver_outputs(eng, prompts, new, *, deferred=True, **drv_kw):
    """Serve ``prompts`` through an AsyncDriver; ({rid: out}, driver)."""
    drv = AsyncDriver(eng, start=not deferred, **drv_kw)
    streams = [drv.submit(p, max_new=new, rid=i)
               for i, p in enumerate(prompts)]
    if deferred:
        drv.start()
    out = {s.rid: s.tokens() for s in streams}
    records = {s.rid: s.result(timeout=TIMEOUT) for s in streams}
    drv.stop(drain=True, timeout=TIMEOUT)
    assert all(r.done for r in records.values())
    assert out == {rid: list(r.out) for rid, r in records.items()}
    assert not any(t.is_alive() for t in drv._threads)
    return out, drv


# ------------------------------------------------------- metric math

def test_quantile_empty_is_nan():
    assert math.isnan(quantile([], 0.5))
    h = Histogram("h")
    assert all(math.isnan(v) for v in h.quantiles())
    assert 'h{quantile="0.5"} NaN' in "\n".join(h.render())


def test_quantile_one_sample_is_that_sample():
    assert quantile([7.0], 0.0) == quantile([7.0], 1.0) == 7.0
    h = Histogram("h")
    h.observe(0.25)
    assert h.quantiles([0.5, 0.9, 0.99]) == [0.25, 0.25, 0.25]


def test_quantile_linear_interpolation():
    vals = [float(v) for v in range(101)]
    assert quantile(vals, 0.5) == 50.0
    assert quantile(vals, 0.9) == 90.0
    assert quantile(vals, 0.99) == 99.0
    assert quantile([1.0, 2.0, 3.0, 4.0], 0.5) == 2.5
    with pytest.raises(ValueError):
        quantile(vals, 1.5)


def test_histogram_window_exact_count_sum():
    h = Histogram("h", window=4)
    for v in range(1, 11):
        h.observe(float(v))
    assert h.count == 10 and h.sum == 55.0
    assert h.quantile(0.0) == 7.0 and h.quantile(1.0) == 10.0


def test_registry_render_and_reset():
    r = MetricsRegistry()
    c = r.counter("reqs_total", "requests")
    g = r.gauge("depth")
    h = r.histogram("lat_seconds")
    c.inc(3)
    g.set(2)
    h.observe(0.5)
    h.observe(1.5)
    text = r.render()
    for line in ("# HELP reqs_total requests", "# TYPE reqs_total counter",
                 "reqs_total 3.0", "# TYPE lat_seconds summary",
                 'lat_seconds{quantile="0.5"} 1.0', "lat_seconds_sum 2.0",
                 "lat_seconds_count 2"):
        assert line in text
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        r.counter("reqs_total")
    r.reset()
    assert c.value == 0.0 and g.value == 0.0 and h.count == 0


def test_serve_metrics_render_engine_stats():
    m = ServeMetrics()
    m.ttft.observe(0.1)
    text = m.render(extra={"pages_in_use": 3, "paged": True,
                           "replicas": [{"x": 1}], "wall_time_s": 0.5})
    assert 'serve_ttft_seconds{quantile="0.5"} 0.1' in text
    assert "serve_engine_pages_in_use 3.0" in text
    assert "serve_engine_wall_time_s 0.5" in text
    assert "serve_engine_paged" not in text
    assert "serve_engine_replicas" not in text
    lat = m.latency_summary()
    assert lat["ttft_p50_s"] == 0.1
    assert math.isnan(lat["tpot_p99_s"])


def _metric_lines(text):
    return {ln.split()[2] if ln.startswith("# ") else ln.split(" ")[0]
            for ln in text.splitlines() if ln}


def test_every_prometheus_metric_name_is_the_reference_s():
    """Scrapers and dashboards keep working: the port's ServeMetrics
    renders exactly the reference's metric names, HELP and TYPE lines."""
    extra = {"pages_in_use": 3, "spec_drafted": 4, "decode_backend": "x"}
    ref, port = jax_metrics.ServeMetrics(), ServeMetrics()
    for m in (ref, port):
        m.ttft.observe(0.1)
        m.step_phase.observe("dispatch", 0.01)
    want = [ln for ln in ref.render(extra=extra).splitlines()
            if ln.startswith("#")]
    got = [ln for ln in port.render(extra=extra).splitlines()
           if ln.startswith("#")]
    assert got == want
    assert _metric_lines(port.render(extra=extra)) == \
        _metric_lines(ref.render(extra=extra))


# --------------------------------------------------- streaming parity

def test_stream_matches_run_dense(weights):
    """The driver's streams equal the port's batch ``run()`` and the JAX
    engine's on the same weights and prompts."""
    jcfg, jp, tp = weights
    prompts = _prompts(0, (5, 7, 6, 8))
    base = _batch(ServeEngine(CFG, tp, **ENG), prompts, 6)
    assert base == _batch(JaxEngine(jcfg, jp, **ENG), prompts, 6)
    eng = ServeEngine(CFG, tp, **ENG)
    out, drv = _driver_outputs(eng, prompts, 6)
    assert out == base
    assert eng.stats["decode_traces"] == 1
    assert drv.metrics.ttft.count == len(prompts)
    assert drv.metrics.completed.value == len(prompts)
    lat = drv.metrics.latency_summary()
    assert lat["ttft_p50_s"] > 0.0 and lat["tpot_p50_s"] >= 0.0
    assert not eng.finished and not drv._streams


def test_session_serve_async_matches_run(weights):
    """``Session.serve_async(start=False)``: submit all, then start; the
    streams equal ``Session.serve()``'s batch run, spec on."""
    _, _, tp = weights
    session = Session(CFG, device="cpu", params=tp)
    prompts = _prompts(1, (5, 9, 7))
    kw = dict(slots=2, max_len=64, chunk_tokens=16, spec=SpecConfig(k=2))
    base = _batch(session.serve(**kw), prompts, 5)
    drv = session.serve_async(start=False, **kw)
    assert drv.engine.spec is not None and drv.engine.device.type == "cpu"
    streams = [drv.submit(p, max_new=5, rid=i)
               for i, p in enumerate(prompts)]
    drv.start()
    out = {s.rid: s.tokens() for s in streams}
    drv.stop(drain=True, timeout=TIMEOUT)
    assert out == base
    assert not any(t.is_alive() for t in drv._threads)


def _router(params, **kw):
    """A dp 2 router of ``ENG`` engines, both replicas on the CPU."""
    return ReplicaRouter(CFG, params, dp=2, devices=["cpu"] * 2,
                         **{**ENG, **kw})


def test_stream_matches_run_dp2(weights):
    """tests/test_serve_online.py:188: the driver over a dp 2 router
    streams the single engine's batch output (the JAX engine's too), one
    program shape a replica."""
    jcfg, jp, tp = weights
    prompts = _prompts(2, (5, 7, 6, 8, 5, 4))
    base = _batch(JaxEngine(jcfg, jp, **ENG), prompts, 6)
    assert base == _batch(ServeEngine(CFG, tp, **ENG), prompts, 6)
    router = _router(tp)
    out, drv = _driver_outputs(router, prompts, 6)
    assert out == base
    assert all(r["decode_traces"] == 1 for r in router.stats["replicas"])
    assert drv.metrics.completed.value == len(prompts)


def test_live_submit_while_running(weights):
    _, _, tp = weights
    prompts = _prompts(3, (5, 7, 6))
    base = _batch(ServeEngine(CFG, tp, **ENG), prompts, 5)
    eng = ServeEngine(CFG, tp, **ENG)
    with AsyncDriver(eng) as drv:
        streams = []
        for i, p in enumerate(prompts):
            streams.append(drv.submit(p, max_new=5, rid=i))
            time.sleep(0.01)
        out = {s.rid: list(s.result(timeout=TIMEOUT).out) for s in streams}
    assert out == base


# ------------------------------------------------- engine stats hooks

def test_reset_stats_keeps_trace_counters(weights):
    _, _, tp = weights
    prompts = _prompts(4, (5, 7))
    eng = ServeEngine(CFG, tp, **ENG)
    _batch(eng, prompts, 4)
    st = eng.stats
    assert st["step_count"] > 0 and st["decode_tokens"] >= 2 * 4
    assert st["wall_time_s"] > 0.0 and st["tokens_per_s_ewma"] > 0.0
    eng.reset_stats()
    assert eng.stats["step_count"] == 0 and eng.stats["decode_steps"] == 0
    assert eng.stats["wall_time_s"] == 0.0
    assert eng.stats["decode_traces"] == 1
    assert eng.stats["prefill_traces"] == 0
    for i, p in enumerate(prompts):
        eng.submit(10 + i, p, max_new=4)
    eng.run()
    assert eng.stats["decode_traces"] == 1


def test_router_stats_aggregate_and_reset(weights):
    """tests/test_serve_online.py:247: the router's stats sum the
    replicas' (no double counting), and ``reset_stats`` resets every
    replica but its program-shape counts."""
    _, _, tp = weights
    router = _router(tp)
    for i, p in enumerate(_prompts(5, (5, 7, 6, 8))):
        router.submit(i, p, max_new=4)
    router.run()
    st = router.stats
    per = st["replicas"]
    assert st["step_count"] == sum(r["step_count"] for r in per)
    assert st["decode_tokens"] == sum(r["decode_tokens"] for r in per)
    assert st["tokens_per_s_ewma"] == pytest.approx(
        sum(r["tokens_per_s_ewma"] for r in per))
    assert st["decode_backend"] == "plain"
    router.reset_stats()
    st = router.stats
    assert st["step_count"] == 0
    assert all(r["decode_traces"] == 1 for r in st["replicas"])


def test_router_latency_aware_routing(weights):
    """tests/test_serve_online.py:268: with both EWMAs set the router
    scores load / rate (the 4x faster replica takes the request at equal
    load); while a replica is cold the least load decides."""
    _, _, tp = weights
    router = _router(tp, slots=1)
    p = np.arange(5, dtype=np.int32) % CFG.vocab_size
    assert router.route(p) == 0
    router.engines[0].stats["tokens_per_s_ewma"] = 10.0
    assert router.route(p) == 0                 # replica 1 still cold
    router.engines[1].stats["tokens_per_s_ewma"] = 40.0
    router.engines[0].submit(0, p, max_new=4)
    router.engines[1].submit(1, p, max_new=4)
    assert router.route(p) == 1                 # 1/40 < 1/10


def test_decode_blocks_register_into_prefix_cache(weights):
    _, _, tp = weights
    eng = ServeEngine(CFG, tp, slots=1, max_len=64, paged=True,
                      page_size=8, prefix_cache=True)
    prompt = (np.arange(8) % 128).astype(np.int32)
    eng.submit(0, prompt, max_new=17)
    out = eng.run()[0].out
    assert eng.stats["prefix_decode_blocks"] >= 2
    replay = np.concatenate([prompt, np.asarray(out[:16], np.int32)])
    hits0 = eng.stats["prefix_hit_blocks"]
    eng.submit(1, replay, max_new=2)
    eng.run()
    assert eng.stats["prefix_hit_blocks"] - hits0 >= 3


# ----------------------------------------------------------- watchdog

def test_watchdog_detects_injected_stall(weights, caplog):
    """A stalled step fires the watchdog: a diagnostic dump at ERROR naming
    the stalled step, the active slot and the pool; every active slot
    cancelled and requeued through ``preempt``; the request completes with
    the batch output."""
    _, _, tp = weights
    prompts = _prompts(7, (6,))
    base = _batch(ServeEngine(CFG, tp, **ENG), prompts, 8)
    eng = ServeEngine(CFG, tp, **ENG)
    eng.submit(100, prompts[0], max_new=2)
    eng.run()
    calls = {"n": 0, "stall_id": None}

    def step_fn(drv):
        calls["n"] += 1
        if calls["n"] == 2:
            calls["stall_id"] = eng.stats["step_count"]
            deadline = time.monotonic() + 20.0
            while not drv.abort_step.is_set() and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            return
        drv.engine.step()

    drv = AsyncDriver(eng, watchdog_timeout=0.25, step_fn=step_fn,
                      start=False)
    with caplog.at_level(logging.ERROR, logger="repro_torch.serve"):
        stream = drv.submit(prompts[0], max_new=8, rid=0)
        t0 = time.monotonic()
        drv.start()
        rec = stream.result(timeout=TIMEOUT)
        drv.stop(drain=True, timeout=TIMEOUT)
    assert rec.done and list(rec.out) == base[0]
    assert drv.metrics.watchdog_fired.value >= 1
    assert drv.metrics.watchdog_requeued.value >= 1
    assert eng.stats["preemptions"] >= 1
    text = caplog.text
    m = re.search(r"step (\d+) stalled", text)
    assert m, text
    assert int(m.group(1)) == calls["stall_id"]
    assert re.search(r"slot r0/s\d+: rid=0", text)
    assert re.search(r"pool r0: \d+ pages in use, \d+ free", text)
    assert re.search(r"flight r0 step \d+:", text)
    assert "dispatch=" in text
    assert "requeued 1 active request(s)" in text
    assert time.monotonic() - t0 < 20.0
    assert not drv.abort_step.is_set()


def test_driver_wires_abort_event_and_recovers_mid_prefill(weights):
    """tests/test_serve_mixed.py:341 on the port: the driver hands its
    ``abort_step`` to the mixed engine; a stall while a long prompt is
    mid-prefill fires the watchdog, yields at sub-step latency, and the
    requeued request completes with the split path's output."""
    _, _, tp = weights
    prompt = np.random.default_rng(31).integers(
        0, 128, size=(40,)).astype(np.int32)
    base = _batch(ServeEngine(CFG, tp, slots=1, max_len=64, paged=True,
                              mixed=False), [prompt], 6)
    eng = ServeEngine(CFG, tp, slots=1, max_len=64, paged=True, mixed=True,
                      chunk_tokens=8)
    eng.submit(100, prompt[:6], max_new=2)
    eng.run()
    calls = {"n": 0}
    yielded = {"dt": None}

    def step_fn(drv):
        calls["n"] += 1
        if calls["n"] == 3:
            t0 = time.monotonic()
            while not drv.abort_step.is_set() and \
                    time.monotonic() - t0 < 20.0:
                time.sleep(0.02)
            yielded["dt"] = time.monotonic() - t0
            return
        drv.engine.step()

    drv = AsyncDriver(eng, watchdog_timeout=0.25, step_fn=step_fn,
                      start=False)
    assert eng.abort_event is drv.abort_step
    stream = drv.submit(prompt, max_new=6, rid=0)
    drv.start()
    rec = stream.result(timeout=TIMEOUT)
    drv.stop(drain=True, timeout=TIMEOUT)
    assert rec.done and list(rec.out) == base[0]
    assert drv.metrics.watchdog_fired.value >= 1
    assert eng.stats["preemptions"] >= 1
    assert yielded["dt"] is not None and yielded["dt"] < 5.0
    assert not drv.abort_step.is_set()


def test_ttft_stamped_for_finish_at_admission(weights):
    _, _, tp = weights
    eng = ServeEngine(CFG, tp, slots=1, max_len=64, paged=True, mixed=True,
                      chunk_tokens=8)
    drv = AsyncDriver(eng, start=False)
    stream = drv.submit(np.arange(5, dtype=np.int32), max_new=1)
    drv.start()
    rec = stream.result(timeout=TIMEOUT)
    drv.stop(drain=True, timeout=TIMEOUT)
    assert rec.done and len(rec.out) == 1
    assert stream.first_token_s is not None and stream.first_token_s > 0
    assert drv.metrics.ttft.count == 1


def test_driver_exposes_spec_metrics(weights):
    """tests/test_serve_spec.py:274 on the port: the drafted/accepted
    totals, the accept-rate gauge and the tokens-per-(step, slot) summary
    reach the driver's metrics and /metrics text."""
    _, _, tp = weights
    rng = np.random.default_rng(12)
    prompts = []
    for _ in range(3):
        motif = rng.integers(0, 128, size=(int(rng.integers(3, 6)),))
        prompts.append(np.tile(motif, int(rng.integers(4, 7)))
                       .astype(np.int32))
    eng = ServeEngine(CFG, tp, slots=2, max_len=64, paged=True, mixed=True,
                      chunk_tokens=16, spec=SpecConfig(k=4))
    drv = AsyncDriver(eng, start=False)
    streams = [drv.submit(p, max_new=12, rid=i)
               for i, p in enumerate(prompts)]
    drv.start()
    records = {s.rid: s.result(timeout=TIMEOUT) for s in streams}
    drv.stop(drain=True, timeout=TIMEOUT)
    assert all(r.done for r in records.values())
    m = drv.metrics
    assert m.spec_drafted.value == eng.stats["spec_drafted"] > 0
    assert m.spec_accepted.value == eng.stats["spec_accepted"] > 0
    assert m.spec_accept_rate.value == pytest.approx(
        eng.stats["spec_accepted"] / eng.stats["spec_drafted"])
    assert m.spec_tokens_per_step.count > 0
    assert m.ttft.count == len(prompts)
    assert all(len(r.out) == 12 for r in records.values())
    text = drv.render_metrics()
    assert f"serve_spec_drafted_total {float(eng.stats['spec_drafted'])}" \
        in text
    assert f"serve_engine_spec_drafted {float(eng.stats['spec_drafted'])}" \
        in text


# ---------------------------------------------------------- HTTP layer

def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()


def _post(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=TIMEOUT)


def test_http_endpoints_over_socket(weights):
    _, _, tp = weights
    prompts = _prompts(8, (5, 7))
    base = _batch(ServeEngine(CFG, tp, **ENG), prompts, 6)
    eng = ServeEngine(CFG, tp, **ENG)
    with serve_http(eng, port=0) as server:
        with _post(f"{server.url}/generate",
                   {"prompt": [int(t) for t in prompts[0]],
                    "max_new": 6}) as r:
            body = json.loads(r.read())
        assert body["done"] is True and body["tokens"] == base[0]
        with _post(f"{server.url}/generate",
                   {"prompt": [int(t) for t in prompts[1]], "max_new": 6,
                    "stream": True}) as r:
            assert r.headers["Transfer-Encoding"] == "chunked"
            lines = [json.loads(ln) for ln in r if ln.strip()]
        *toks, closing = lines
        assert [ln["token"] for ln in toks] == base[1]
        assert [ln["index"] for ln in toks] == list(range(6))
        assert closing["done"] is True and closing["tokens"] == base[1]
        metrics = _get(f"{server.url}/metrics")
        for name in ("serve_ttft_seconds", "serve_tpot_seconds"):
            for q in ("0.5", "0.9", "0.99"):
                assert f'{name}{{quantile="{q}"}}' in metrics
        assert "serve_requests_completed_total 2.0" in metrics
        assert "serve_engine_pages_in_use" in metrics
        assert "serve_engine_preemptions" in metrics
        health = json.loads(_get(f"{server.url}/healthz"))
        assert health["status"] == "ok" and health["step_count"] > 0
        for bad in ({"max_new": 4}, {"prompt": ["a", "b"]}, {"prompt": []},
                    {"prompt": [1, 2], "timeout": "soon"}):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"{server.url}/generate", bad)
            assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{server.url}/nope")
        assert ei.value.code == 404
    assert not server._thread.is_alive()


def test_session_serve_http_with_spec_from_threads(weights):
    """``Session.serve_http(port=0, spec=...)``: concurrent clients get
    their ``max_new`` tokens, one TTFT each lands in /metrics, and the
    spec counter in /metrics is the engine's."""
    _, _, tp = weights
    session = Session(CFG, device="cpu", params=tp)
    prompts = _prompts(9, (5, 7, 9, 6))
    server = session.serve_http(port=0, slots=2, max_len=64,
                                chunk_tokens=16, spec=SpecConfig(k=2))
    bodies = {}

    def client(i):
        with _post(f"{server.url}/generate",
                   {"prompt": [int(t) for t in prompts[i]],
                    "max_new": 5}) as r:
            bodies[i] = json.loads(r.read())

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert sorted(bodies) == list(range(len(prompts)))
        assert all(len(b["tokens"]) == 5 for b in bodies.values())
        metrics = _get(f"{server.url}/metrics")
        assert f"serve_ttft_seconds_count {len(prompts)}" in metrics
        drafted = server.driver.stats()["spec_drafted"]
        assert f"serve_engine_spec_drafted {float(drafted)}" in metrics
    finally:
        server.close(drain=False)


def test_generate_without_timeout_504s_on_stall(weights):
    _, _, tp = weights
    prompts = _prompts(9, (5,))
    eng = ServeEngine(CFG, tp, **ENG)

    def stalled_step(drv):
        time.sleep(0.05)

    drv = AsyncDriver(eng, step_fn=stalled_step)
    try:
        with ServeHTTPServer(drv, port=0, result_timeout=0.5) as server:
            t0 = time.monotonic()
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"{server.url}/generate",
                      {"prompt": [int(t) for t in prompts[0]],
                       "max_new": 4})
            assert ei.value.code == 504
            body = json.loads(ei.value.read())
            assert "rid" in body and "error" in body
            assert time.monotonic() - t0 < 30.0
            t0 = time.monotonic()
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(f"{server.url}/generate",
                      {"prompt": [int(t) for t in prompts[0]],
                       "max_new": 4, "timeout": 0.1})
            assert ei.value.code == 504
            assert time.monotonic() - t0 < 30.0
    finally:
        drv.stop(drain=False, timeout=TIMEOUT)


# ------------------------------------------------------ save / restore

def test_session_save_restore_round_trip(weights, tmp_path):
    """``save`` then ``restore`` into a fresh session gives the same
    params bit for bit (and so the same streams); ``restore`` of an empty
    directory returns None and keeps the params."""
    _, _, tp = weights
    ckpt = str(tmp_path / "ck")
    session = Session(CFG, device="cpu", params=tp)
    session.save(ckpt, step=3)
    fresh = Session(CFG, device="cpu", seed=5)
    before = fresh.params["embed"].clone()
    assert not torch.equal(before, tp["embed"])
    assert fresh.restore(str(tmp_path / "none")) is None
    assert torch.equal(fresh.params["embed"], before)
    assert fresh.restore(ckpt) == 3
    for key in ("embed", "lm_head"):
        assert torch.equal(fresh.params[key], tp[key])
    assert torch.equal(fresh.params["layers"]["mlp"]["w_down"],
                       tp["layers"]["mlp"]["w_down"])
    prompts = _prompts(2, (5, 8))
    kw = dict(slots=2, max_len=64)
    assert _batch(fresh.serve(**kw), prompts, 4) == \
        _batch(session.serve(**kw), prompts, 4)


def test_restore_survives_an_optimizer_step(tmp_path):
    """tests/test_api_session.py:104 on the port: a trainer checkpoint is
    restored by a fresh session's trainer at its step, and a zero-lr step
    keeps the restored params (AdamW's update reads them, not a stale
    copy)."""
    ckpt = str(tmp_path / "ck")
    session = Session(CFG, device="cpu", seed=1)
    t1 = session.train(TrainConfig(steps=2, lr=1e-2, checkpoint_every=2,
                                   checkpoint_dir=ckpt),
                       global_batch=4, seq_len=16)
    t1.run()
    saved = t1.params["embed"].detach().clone()
    fresh = Session(CFG, device="cpu", seed=2)
    t2 = fresh.train(TrainConfig(steps=1, lr=0.0, checkpoint_dir=ckpt),
                     global_batch=4, seq_len=16, restore=True)
    assert t2.step == 2
    t2.run(1)
    torch.testing.assert_close(t2.params["embed"].detach(), saved,
                               atol=1e-6, rtol=0)
    # the session's own restore reads the trainer's checkpoint too
    other = Session(CFG, device="cpu", seed=3)
    assert other.restore(ckpt) == 2
    assert torch.equal(other.params["embed"], saved)


@pytest.mark.parametrize("method", ["from_plan"])
def test_planner_entry_points_raise_naming_item_12(weights, method):
    """``from_plan`` (``dryrun`` and ``lower`` are ported too:
    tests/test_torch_dryrun.py): tests/test_api_session.py's one-device
    plan (searched on H100, the reference's on H100's fields: the same
    degrees), materialised with no process group, against JAX's
    ``Session.from_plan(..., devices=1)`` on the same weights (the
    params setter on both): ``generate`` and ``serve()`` give JAX's
    tokens, then two training steps JAX's losses within 1e-4 and params
    within 5e-4 (the reference test's bounds), the session's params the
    trained ones."""
    import dataclasses
    from repro.api import Session as JaxSession
    from repro.api import plan as jax_plan
    from repro.configs.base import ShapeConfig as JaxShape
    from repro.core.costmodel import Hardware as JaxHardware
    from repro.train.trainer import TrainConfig as JaxTrainConfig
    from repro_torch.api import H100, plan
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.tree import flatten
    jcfg, jp, _ = weights
    p = plan(CFG, ShapeConfig("host", 64, 8, "train"), 1)
    jplan = jax_plan(jcfg, JaxShape("host", 64, 8, "train"), 1,
                     hw=JaxHardware(**dataclasses.asdict(H100)))
    assert p.row() == jplan.row()
    knobs = dict(remat=False, microbatches=1, dtype="float32")
    session = Session.from_plan(CFG, p, device="cpu", **knobs)
    jsession = JaxSession.from_plan(jcfg, jplan, devices=1, **knobs)
    assert session.plan is p and session.mesh is None
    assert session.strategy == session.strategy.with_(
        name="plan/exhaustive", **knobs)
    # copies: the port trains its tree in place, JAX's step donates
    session.params = from_numpy(_flatten(jp), CFG, "cpu")
    jsession.params = jax.tree.map(lambda x: x.copy(), jp)
    prompt = np.asarray(_prompts(9, (8,))[0])[None].repeat(2, 0)
    assert np.array_equal(session.generate(prompt, steps=4).numpy(),
                          np.asarray(jsession.generate(prompt, steps=4)))
    prompts = _prompts(3, (5, 7, 6))
    got = _batch(session.serve(slots=2, max_len=64), prompts, 5)
    assert got == _batch(jsession.serve(slots=2, max_len=64), prompts, 5)
    hist = []
    for sess, tc in ((session, TrainConfig), (jsession, JaxTrainConfig)):
        trainer = sess.train(tc(steps=2, lr=1e-3, log_every=1, seed=3),
                             global_batch=4, seq_len=16)
        trainer.run()
        hist.append([h["loss"] for h in trainer.history])
    np.testing.assert_allclose(hist[0], hist[1], atol=1e-4, rtol=0)
    want = _flatten(jsession.params)
    for key, leaf in flatten(session.params).items():
        np.testing.assert_allclose(leaf.detach().numpy(),
                                   np.asarray(want[key]), atol=5e-4,
                                   rtol=5e-4, err_msg=key)


def test_callers_are_let_in_while_the_loop_stays_busy(weights):
    """Lock handoff under load: with a step that holds the engine lock
    for 20 ms and the engine never idle, 12 threads (more than the
    cores the tests get) submit, read stats and join at once, with a
    short switch interval; every submission returns within a few steps,
    every stream completes with its max_new tokens, and no caller is
    left counted as waiting."""
    import sys
    _, _, tp = weights
    eng = ServeEngine(CFG, tp, slots=2, max_len=64, paged=True)
    eng.submit(1000, _prompts(5, (6,))[0], max_new=40)

    def slow_step(drv):
        time.sleep(0.02)
        drv.engine.step()

    drv = AsyncDriver(eng, step_fn=slow_step)
    prompts = _prompts(6, [5 + i % 4 for i in range(12)])
    waits, streams = {}, {}

    def caller(i):
        t0 = time.monotonic()
        streams[i] = drv.submit(prompts[i], max_new=3, rid=i)
        waits[i] = time.monotonic() - t0
        drv.stats()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert max(waits.values()) < 5.0, waits
        for i, s in streams.items():
            assert len(s.result(timeout=TIMEOUT).out) == 3
    finally:
        sys.setswitchinterval(old)
        drv.stop(drain=False, timeout=TIMEOUT)
    assert drv._waiting == 0
