"""Dependency-free serving metrics: counters, gauges, quantile histograms —
the port's copy of ``repro/serve/metrics.py`` (every metric name kept).

The survey's systems thread (Nagrecha 2023) is blunt about it: parallel
execution is only half a serving system — the other half is the
operational machinery that tells you whether it is actually serving.
This module is that half's measurement layer, deliberately free of any
client library so it imports anywhere the engine does:

  * :class:`Counter` — monotone float/int accumulator (``inc``);
  * :class:`Gauge` — last-write-wins instantaneous value (``set``);
  * :class:`Histogram` — streaming observations with exact ``count`` /
    ``sum`` and windowed p50/p90/p99 quantiles over the most recent
    ``window`` samples (a bounded deque, so a long-lived server never
    grows without bound; the window is large enough that steady-state
    percentiles are stable). Rendered as a Prometheus ``summary``.
  * :class:`MetricsRegistry` — names -> instruments, rendered in the
    Prometheus text exposition format (``GET /metrics`` serves exactly
    :meth:`MetricsRegistry.render`'s output).
  * :class:`ServeMetrics` — the serving-specific facade the AsyncDriver
    records into: per-request TTFT (submit -> first token) and TPOT
    (inter-token gap after the first), per-step latency and batch
    occupancy, stream/watchdog counters, plus a snapshot hook that
    exports ``engine.stats`` (pool/prefix/preemption telemetry) as
    gauges at scrape time.

Every instrument is thread-safe (one lock each): the driver loop records
while the HTTP scrape thread renders.

Metric glossary (the names ``GET /metrics`` exposes):

  ``serve_ttft_seconds``            summary   submit -> first streamed token
  ``serve_tpot_seconds``            summary   gap between consecutive tokens
  ``serve_e2e_seconds``             summary   submit -> request completion
  ``serve_step_seconds``            summary   one engine step, wall time
  ``serve_step_occupancy``          summary   active slots entering a step
  ``serve_step_phase_seconds``      summary   host time one step spent in
                                              each phase, labelled
                                              ``{phase="bookkeeping|draft|
                                              pack|dispatch|sync|admit"}``
                                              (fed from the tracer's
                                              per-step phase laps)
  ``serve_prefill_chunk_tokens``    summary   prefill tokens one mixed step
                                              processed as chunks (0 on
                                              pure-decode steps; bounded by
                                              the engine's ``chunk_tokens``
                                              budget)
  ``serve_step_prefill_fraction``   summary   prefill share of a mixed
                                              step's work items —
                                              chunk tokens over chunk
                                              tokens + decode tokens
  ``serve_requests_submitted_total``  counter
  ``serve_requests_completed_total``  counter
  ``serve_requests_expired_total``    counter deadline passed while queued
                                              (done=False, expired=True)
  ``serve_tokens_streamed_total``     counter streamed tokens (all requests)
  ``serve_watchdog_fired_total``      counter stalled-step detections
  ``serve_watchdog_requeued_total``   counter requests requeued by recovery
  ``serve_spec_drafted_total``        counter speculative tokens drafted
                                              (verify rows packed into
                                              mixed steps)
  ``serve_spec_accepted_total``       counter drafted tokens the verifier
                                              accepted (greedy prefix
                                              match; bonus tokens not
                                              counted — they are ordinary
                                              decode output)
  ``serve_queue_depth``             gauge     queued requests right now
  ``serve_active_slots``            gauge     occupied slots right now
  ``serve_spec_accept_rate``        gauge     cumulative accepted/drafted
                                              (0 until something drafts)
  ``serve_spec_tokens_per_step``    summary   decode tokens emitted per
                                              decode step (prefill-sampled
                                              first tokens excluded);
                                              > 1.0 is speculation paying
  ``serve_engine_<stat>``           gauge     every numeric ``engine.stats``
                                              field (pages_in_use,
                                              peak_pages, prefix_* ,
                                              preemptions, cow_copies,
                                              decode_steps, step_count,
                                              decode_tokens, wall_time_s,
                                              tokens_per_s_ewma, ...);
                                              string fields export info-
                                              style — decode_backend
                                              (the engine's paged-
                                              attention path) becomes
                                              ``serve_engine_decode_backend
                                              {value="gather|pallas"} 1.0``
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: the quantiles every summary exports (the TTFT/TPOT acceptance set)
QUANTILES = (0.5, 0.9, 0.99)


def quantile(sorted_values: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile of an ascending-sorted sequence
    (numpy's default method, dependency-free). NaN on empty input; the
    single sample for any ``q`` on one-element input."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    n = len(sorted_values)
    if n == 0:
        return float("nan")
    if n == 1:
        return float(sorted_values[0])
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_values[lo]) * (1.0 - frac) \
        + float(sorted_values[hi]) * frac


def _fmt(v: float) -> str:
    """Prometheus sample value: plain float, NaN spelled ``NaN``."""
    if v != v:                      # NaN
        return "NaN"
    return repr(float(v))


class Counter:
    """Monotone accumulator. ``inc`` by any non-negative amount."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(inc {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self):
        with self._lock:
            self._value = 0.0

    def render(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Gauge:
    """Instantaneous value; ``set`` overwrites."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self):
        self.set(0.0)

    def render(self) -> List[str]:
        return [f"{self.name} {_fmt(self.value)}"]


class Histogram:
    """Quantile histogram: exact count/sum, windowed percentiles.

    Keeps the most recent ``window`` observations (bounded memory for a
    long-lived server); ``quantile``/``quantiles`` sort the window on
    demand — scrapes are rare next to observations, so the cost sits on
    the scrape path. Rendered as a Prometheus ``summary`` with the
    :data:`QUANTILES` labels plus ``_sum``/``_count`` series.
    """

    kind = "summary"

    def __init__(self, name: str, help: str = "", *, window: int = 4096):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.name, self.help = name, help
        self.window = window
        self._lock = threading.Lock()
        self._samples: deque = deque(maxlen=window)
        self._count = 0
        self._sum = 0.0

    def observe(self, value: float):
        with self._lock:
            self._samples.append(float(value))
            self._count += 1
            self._sum += float(value)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        return self.quantiles([q])[0]

    def quantiles(self, qs: Iterable[float] = QUANTILES) -> List[float]:
        """One sort, many quantiles — NaN-filled when no samples yet."""
        with self._lock:
            window = sorted(self._samples)
        return [quantile(window, q) for q in qs]

    def snapshot(self) -> Tuple[List[float], float, int]:
        """(sorted window, sum, count) captured under ONE lock
        acquisition, so a render's quantiles and its ``_sum``/``_count``
        lines describe the same instant even while another thread
        observes concurrently."""
        with self._lock:
            return sorted(self._samples), self._sum, self._count

    def reset(self):
        with self._lock:
            self._samples.clear()
            self._count = 0
            self._sum = 0.0

    def render(self) -> List[str]:
        window, total, count = self.snapshot()
        lines = [f'{self.name}{{quantile="{q}"}} {_fmt(quantile(window, q))}'
                 for q in QUANTILES]
        lines.append(f"{self.name}_sum {_fmt(total)}")
        lines.append(f"{self.name}_count {count}")
        return lines


class LabeledHistogram:
    """A family of :class:`Histogram` children keyed by one label value
    (e.g. ``serve_step_phase_seconds{phase="dispatch"}``): one registered
    name, one ``TYPE summary`` header, per-label quantile/sum/count
    series. Children are created on first ``observe`` — label sets are
    small and bounded by the caller (the engine's phase names)."""

    kind = "summary"

    def __init__(self, name: str, help: str = "", *, label: str = "label",
                 window: int = 4096):
        self.name, self.help = name, help
        self.label = label
        self.window = window
        self._lock = threading.Lock()
        self._children: Dict[str, Histogram] = {}

    def child(self, value: str) -> Histogram:
        value = str(value)
        with self._lock:
            h = self._children.get(value)
            if h is None:
                h = self._children[value] = Histogram(
                    self.name, window=self.window)
            return h

    def observe(self, label_value: str, value: float):
        self.child(label_value).observe(value)

    def labels(self) -> List[str]:
        with self._lock:
            return sorted(self._children)

    def reset(self):
        with self._lock:
            children = list(self._children.values())
        for h in children:
            h.reset()

    def render(self) -> List[str]:
        with self._lock:
            items = sorted(self._children.items())
        lines: List[str] = []
        for lv, h in items:
            window, total, count = h.snapshot()
            for q in QUANTILES:
                lines.append(
                    f'{self.name}{{{self.label}="{lv}",quantile="{q}"}} '
                    f'{_fmt(quantile(window, q))}')
            lines.append(
                f'{self.name}_sum{{{self.label}="{lv}"}} {_fmt(total)}')
            lines.append(
                f'{self.name}_count{{{self.label}="{lv}"}} {count}')
        return lines


class MetricsRegistry:
    """Ordered name -> instrument map with Prometheus text rendering."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _register(self, metric):
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"metric {metric.name!r} already "
                                 "registered")
            self._metrics[metric.name] = metric
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge(name, help))

    def histogram(self, name: str, help: str = "", *,
                  window: int = 4096) -> Histogram:
        return self._register(Histogram(name, help, window=window))

    def labeled_histogram(self, name: str, help: str = "", *,
                          label: str = "label",
                          window: int = 4096) -> LabeledHistogram:
        return self._register(
            LabeledHistogram(name, help, label=label, window=window))

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def reset(self):
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4): HELP/TYPE
        headers then the samples, one instrument after another."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: List[str] = []
        for m in metrics:
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            out.extend(m.render())
        return "\n".join(out) + "\n"


class ServeMetrics:
    """The serving facade: every instrument the AsyncDriver records.

    ``render(extra=engine.stats)`` additionally exports each numeric
    stats field as a ``serve_engine_<name>`` gauge, so one scrape carries
    the latency picture AND the pool/prefix/preemption telemetry the
    engine already keeps. String fields (``decode_backend``) export
    info-style — ``serve_engine_decode_backend{value="pallas"} 1.0``;
    other non-numeric fields (the router's per-replica breakdown list)
    are skipped; per-replica detail stays available via ``stats``
    itself.
    """

    def __init__(self, *, window: int = 4096):
        r = self.registry = MetricsRegistry()
        self.ttft = r.histogram(
            "serve_ttft_seconds",
            "Time from submit to the request's first streamed token",
            window=window)
        self.tpot = r.histogram(
            "serve_tpot_seconds",
            "Gap between a request's consecutive streamed tokens",
            window=window)
        self.e2e = r.histogram(
            "serve_e2e_seconds",
            "Time from submit to request completion", window=window)
        self.step_latency = r.histogram(
            "serve_step_seconds", "Engine step wall time", window=window)
        self.occupancy = r.histogram(
            "serve_step_occupancy",
            "Active slots entering each engine step", window=window)
        self.step_phase = r.labeled_histogram(
            "serve_step_phase_seconds",
            "Host-side time one engine step spent in each phase "
            "(bookkeeping/draft/pack/dispatch/sync; legacy adds admit)",
            label="phase", window=window)
        self.prefill_chunk = r.histogram(
            "serve_prefill_chunk_tokens",
            "Prefill tokens processed as chunks by one mixed step",
            window=window)
        self.prefill_frac = r.histogram(
            "serve_step_prefill_fraction",
            "Prefill share of one mixed step's processed tokens",
            window=window)
        self.submitted = r.counter(
            "serve_requests_submitted_total", "Requests accepted")
        self.completed = r.counter(
            "serve_requests_completed_total", "Requests completed")
        self.expired = r.counter(
            "serve_requests_expired_total",
            "Requests whose deadline passed while still queued")
        self.tokens = r.counter(
            "serve_tokens_streamed_total", "Tokens streamed to requests")
        self.watchdog_fired = r.counter(
            "serve_watchdog_fired_total",
            "Stalled/over-deadline steps the watchdog detected")
        self.watchdog_requeued = r.counter(
            "serve_watchdog_requeued_total",
            "Requests cancelled-and-requeued by watchdog recovery")
        self.spec_drafted = r.counter(
            "serve_spec_drafted_total",
            "Speculative tokens drafted (verify rows packed)")
        self.spec_accepted = r.counter(
            "serve_spec_accepted_total",
            "Drafted tokens the verifier accepted")
        self.spec_accept_rate = r.gauge(
            "serve_spec_accept_rate",
            "Cumulative speculative accept rate (accepted / drafted)")
        self.spec_tokens_per_step = r.histogram(
            "serve_spec_tokens_per_step",
            "Decode tokens emitted per decode step under speculation",
            window=window)
        self.queue_depth = r.gauge(
            "serve_queue_depth", "Requests queued right now")
        self.active_slots = r.gauge(
            "serve_active_slots", "Slots decoding right now")
        self._extra_lock = threading.Lock()
        self._extra_gauges: Dict[str, Gauge] = {}

    # ------------------------------------------------------------ summary
    def latency_summary(self) -> Dict[str, float]:
        """The benchmark row: TTFT/TPOT p50/p90/p99 (seconds)."""
        out: Dict[str, float] = {}
        for label, hist in (("ttft", self.ttft), ("tpot", self.tpot)):
            for q, v in zip(QUANTILES, hist.quantiles(QUANTILES)):
                out[f"{label}_p{int(q * 100)}_s"] = v
        return out

    # ------------------------------------------------------------- render
    def render(self, extra: Optional[Dict] = None) -> str:
        """Prometheus text: the driver instruments plus, when ``extra``
        (an ``engine.stats`` dict) is given, one ``serve_engine_<k>``
        gauge per numeric field."""
        text = self.registry.render()
        if not extra:
            return text
        lines: List[str] = []
        for key, value in extra.items():
            name = f"serve_engine_{key}"
            if isinstance(value, str):
                # identity fields (decode_backend) export Prometheus
                # info-style: constant 1 with the value as a label
                lines.append(f"# TYPE {name} gauge")
                lines.append(f'{name}{{value="{value}"}} 1.0')
                continue
            if isinstance(value, bool) or not isinstance(value,
                                                         (int, float)):
                continue
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(float(value))}")
        return text + "\n".join(lines) + ("\n" if lines else "")
