"""Deadlines and the chunk-boundary abort in the port's ``ServeEngine``
(tests/test_serve_mixed.py:244-317 on the port, CPU): EDF admission,
expiry while queued, ``deadline_s`` validation, the nearest deadline's
prefill first, and ``abort_event`` polled before a mixed step launches
its program. Where a case produces streams, they equal the JAX engine's
on the same traffic and weights. The driver test (:341) waits for the
online stack (ROADMAP Queue 1 item 6)."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

#: tests/test_serve_mixed.py's CFG
KW = dict(name="mixed-dense", arch_type="dense", num_layers=2, d_model=64,
          num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
          dtype="float32")
CFG = ModelConfig(**KW)
ENGINE_KW = dict(slots=1, max_len=64, paged=True, mixed=True,
                 chunk_tokens=8)


@pytest.fixture(scope="module")
def weights():
    jcfg = JaxConfig(**KW)
    jparams = get_model(jcfg).init(jax.random.key(0), jcfg)
    return jcfg, jparams, from_numpy(_flatten(jparams), CFG, "cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=(int(n),)).astype(np.int32)
            for n in lens]


def _finish_order(eng):
    order = []
    for _ in range(300):
        eng.step()
        order += [rid for rid in eng.finished if rid not in order]
        if not eng.busy():
            break
    return order


def test_deadline_edf_jumps_fifo(weights):
    """:244 — a queued deadline request admits before earlier
    deadline-free ones; FIFO breaks ties; streams as the JAX engine's."""
    jcfg, jparams, params = weights
    prompts = _prompts(17, (5, 6, 7))
    runs = {}
    for name, eng in (("jax", JaxEngine(jcfg, jparams, **ENGINE_KW)),
                      ("port", ServeEngine(CFG, params, **ENGINE_KW))):
        eng.submit(0, prompts[0], max_new=2)
        eng.submit(1, prompts[1], max_new=2)
        eng.submit(2, prompts[2], max_new=2, deadline_s=30.0)
        order = _finish_order(eng)
        runs[name] = (order, {i: list(r.out) for i, r in
                              eng.finished.items()})
    assert runs["port"][0] == [2, 0, 1]
    assert runs["port"] == runs["jax"]


def test_deadline_expired_while_queued(weights):
    """:265 — a request whose deadline passes while QUEUED finishes
    done=False, expired=True with no tokens; the active one never
    expires."""
    _, _, params = weights
    prompts = _prompts(19, (30, 6))
    eng = ServeEngine(CFG, params, **ENGINE_KW)
    eng.submit(0, prompts[0], max_new=8, deadline_s=60.0)  # gets the slot
    eng.submit(1, prompts[1], max_new=4, deadline_s=0.001)
    time.sleep(0.05)
    res = eng.run()
    assert res[0].done and not res[0].expired and len(res[0].out) == 8
    assert res[1].expired and not res[1].done and res[1].out == []
    assert eng.stats["expired"] == 1
    assert eng.stats["pages_in_use"] == 0


@pytest.mark.parametrize("deadline_s", [0.0, -1.0])
def test_deadline_submit_validation(weights, deadline_s):
    """:282 — a deadline must be > 0, on the mixed and split paths."""
    _, _, params = weights
    for mixed in (True, False):
        eng = ServeEngine(CFG, params, slots=1, max_len=64, paged=True,
                          mixed=mixed)
        with pytest.raises(ValueError, match="deadline"):
            eng.submit(0, np.arange(4, dtype=np.int32), max_new=2,
                       deadline_s=deadline_s)
        assert not eng.queue


def test_nearest_deadline_gets_prefill_budget_first(weights):
    """:290 — two long prompts admitted together: the tight budget drains
    the nearer deadline's prompt first, so it emits first; streams as the
    JAX engine's."""
    jcfg, jparams, params = weights
    prompts = _prompts(23, (32, 32))
    kw = dict(ENGINE_KW, slots=2)
    runs = {}
    for name, eng in (("jax", JaxEngine(jcfg, jparams, **kw)),
                      ("port", ServeEngine(CFG, params, **kw))):
        eng.submit(0, prompts[0], max_new=3)                  # no deadline
        eng.submit(1, prompts[1], max_new=3, deadline_s=60.0)
        first = {}
        for step in range(300):
            eng.step()
            live = [r for r in eng.active if r is not None]
            for req in live + list(eng.finished.values()):
                if req.out and req.rid not in first:
                    first[req.rid] = step
            if not eng.busy():
                break
        runs[name] = (first, {i: list(r.out) for i, r in
                              eng.finished.items()})
    first = runs["port"][0]
    assert first[1] < first[0], first
    assert runs["port"] == runs["jax"]


def test_abort_event_yields_at_chunk_boundary(weights):
    """:317 — with ``abort_event`` set a mixed step returns without
    launching a program or moving a prefill cursor; once it clears the
    request finishes with the JAX engine's stream."""
    jcfg, jparams, params = weights
    prompts = _prompts(29, (40,))
    eng = ServeEngine(CFG, params, **ENGINE_KW)
    assert eng.abort_event is None
    eng.submit(0, prompts[0], max_new=4)
    eng.step()                                   # first prefill chunk
    pf = eng.stats["prefill_chunk_tokens"]
    assert pf > 0
    ev = threading.Event()
    eng.abort_event = ev
    ev.set()
    runs = eng.stats["mixed_steps"]
    eng.step()                                   # aborted: no work
    assert eng.stats["prefill_chunk_tokens"] == pf
    assert eng.stats["decode_tokens"] == 0
    assert eng.stats["mixed_steps"] == runs
    ev.clear()
    res = eng.run()
    assert res[0].done and len(res[0].out) == 4
    ref = JaxEngine(jcfg, jparams, **ENGINE_KW)
    ref.submit(0, prompts[0], max_new=4)
    assert res[0].out == ref.run()[0].out
