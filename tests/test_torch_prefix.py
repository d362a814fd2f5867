"""Prefix sharing, lazy growth, copy-on-write, preemption and the
scheduler policies in the port's ``ServeEngine``, held to the JAX engine
on the CPU.

Every dense case of tests/test_serve_prefix.py (and
tests/test_serve_mixed.py:128, tests/test_serve_engine.py:405 and :427)
runs the same traffic through the JAX engine and the port's with the same
keywords on the same weights (JAX-initialised, bridged), and shows three
things: the greedy streams are equal; every prefix, preemption and CoW
counter is equal (host logic, so exactly); the pages come back to the
pool. The reference test's own assertions are kept beside them. The MoE
and enc-dec cases are in tests/test_torch_moe_serve.py and
tests/test_torch_encdec_serve.py.
"""
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.serve import scheduler as jax_sched  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serve import scheduler as port_sched  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.paging import pages_for  # noqa: E402

#: tests/test_serve_prefix.py's CFG (tests/test_serve_engine.py's has the
#: same shapes) and tests/test_serve_mixed.py's
KW = dict(name="prefix-dense", arch_type="dense", num_layers=2, d_model=128,
          num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=128,
          dtype="float32")
MIXED_KW = dict(KW, name="mixed-dense", d_model=64, d_ff=128)
CFG = ModelConfig(**KW)

#: the counters a case holds equal to the JAX engine's
COUNTERS = ("prefix_hit_blocks", "prefix_miss_blocks", "prefix_tail_hits",
            "prefix_evictions", "preemptions", "cow_copies",
            "prefix_decode_blocks", "prefills", "decode_tokens",
            "peak_pages", "decode_traces", "prefill_traces")

ENGINES = {"jax": (JaxEngine, jax_sched), "port": (ServeEngine, port_sched)}


@pytest.fixture(scope="module")
def weights():
    """(cfg keywords, seed) -> (JAX params, the port's on the CPU)."""
    cache = {}

    def get(kw, seed):
        key = (kw["name"], seed)
        if key not in cache:
            jcfg = JaxConfig(**kw)
            jp = get_model(jcfg).init(jax.random.key(seed), jcfg)
            cache[key] = (jcfg, jp, ModelConfig(**kw),
                          from_numpy(_flatten(jp), ModelConfig(**kw), "cpu"))
        return cache[key]
    return get


def _both(weights, kw, seed, scenario):
    """Run ``scenario(make, sched)`` on the JAX engine and on the port's:
    ``make(**engine_kw)`` builds an engine on the case's weights, and the
    scenario returns ``(streams, engine, notes)``. Asserts equal streams,
    equal counters and equal notes; returns the port's engine and
    streams."""
    jcfg, jp, cfg, tp = weights(kw, seed)
    runs = {}
    for name, (engine, sched) in ENGINES.items():
        conf, params = (jcfg, jp) if name == "jax" else (cfg, tp)
        runs[name] = scenario(
            lambda **ekw: engine(conf, params, **ekw), sched)
    (want, jeng, jnotes), (got, eng, notes) = runs["jax"], runs["port"]
    assert got == want
    for key in COUNTERS:
        assert eng.stats[key] == jeng.stats[key], key
    assert notes == jnotes
    return eng, got


def _drained(eng):
    """Every page comes back: all but the cached prefix blocks at once,
    those too once the cache is released."""
    assert all(r is None for r in eng.active) and not eng.queue
    cached = len(eng._prefix) if eng._prefix is not None else 0
    assert eng._alloc.pages_in_use == cached
    eng.release_prefix_cache()
    assert eng._alloc.pages_in_use == 0
    assert eng._alloc.free_pages == eng.kv_pages


def _streams(results):
    return {i: list(r.out) for i, r in results.items()}


def _serve_all(make, prompts, new, **ekw):
    eng = make(**ekw)
    for i, p in enumerate(prompts):
        eng.submit(i, p, max_new=new)
    res = eng.run()
    assert all(r.done for r in res.values())
    return _streams(res), eng


def _system_prompts(seed, system_len, tails, vocab=128):
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, size=(system_len,)).astype(np.int32)
    return [np.concatenate([system, rng.integers(
        0, vocab, size=(int(n),)).astype(np.int32)]) for n in tails]


# ------------------------------------------------------------------ parity

@pytest.mark.parametrize("mixed", [True, False])
def test_prefix_shared_lazy_matches_jax(weights, mixed):
    """tests/test_serve_prefix.py:55 on both paged paths: 8 requests
    opening with one 64-token system prompt through 3 slots, prefix cache
    and lazy growth; one program shape and >= 7 x 4 blocks from the
    cache."""
    prompts = _system_prompts(0, 64, (4, 5, 6, 7, 4, 5, 6, 7))

    def scenario(make, sched):
        out, eng = _serve_all(make, prompts, 6, slots=3, max_len=128,
                              paged=True, page_size=16, prefix_cache=True,
                              lazy=True, mixed=mixed)
        return out, eng, None

    eng, _ = _both(weights, KW, 0, scenario)
    assert eng.stats["decode_traces"] == 1
    assert eng.stats["prefix_hit_blocks"] >= 7 * 4
    _drained(eng)


@pytest.mark.parametrize("mixed", [True, False])
def test_cow_tail_share_and_writer_isolation(weights, mixed):
    """tests/test_serve_prefix.py:137: a prompt ending mid-block of a
    cached longer prompt adopts the donor's page for its tail and copies
    it before its first decode write; the donor's page stays intact for a
    third request."""
    base = np.random.default_rng(1).integers(0, 128, size=(16,)).astype(
        np.int32)

    def scenario(make, sched):
        eng = make(slots=2, max_len=64, paged=True, page_size=8,
                   prefix_cache=True, lazy=True, mixed=mixed)
        out = {}
        for rid, prompt in enumerate((base, base[:10], base)):
            eng.submit(rid, prompt, max_new=6)
            out[rid] = list(eng.run()[rid].out)
        return out, eng, None

    eng, out = _both(weights, KW, 1, scenario)
    assert out[2] == out[0]
    assert eng.stats["prefix_tail_hits"] == 1
    assert eng.stats["cow_copies"] == 1
    assert eng.stats["decode_traces"] == 1
    _drained(eng)


def test_lazy_only_matches_jax(weights):
    """tests/test_serve_prefix.py:163: lazy growth without sharing, a
    generous pool: no preemption, and a peak far below the pool."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, size=(int(n),)).astype(np.int32)
               for n in (5, 9, 7, 13)]

    def scenario(make, sched):
        out, eng = _serve_all(make, prompts, 8, slots=2, max_len=64,
                              paged=True, page_size=4, lazy=True)
        return out, eng, None

    eng, _ = _both(weights, KW, 0, scenario)
    assert eng.stats["preemptions"] == 0
    assert eng.stats["peak_pages"] < eng.kv_pages
    _drained(eng)


def test_8_shared_prefix_requests_fit_2_unshared_budget(weights):
    """tests/test_serve_prefix.py:188: 8 requests sharing a 64-token
    prompt are all resident on a pool sized for 2 unshared requests,
    which holds only 2 without sharing."""
    prompts = _system_prompts(4, 64, (4,) * 8)
    pool = 2 * pages_for(min(68 + 4 - 1, 128), 8)
    assert pool == 18

    def scenario(make, sched):
        engines, out, resident = {}, {}, {}
        for share in (False, True):
            eng = make(slots=8, max_len=128, paged=True, page_size=8,
                       kv_pages=pool, prefix_cache=share, lazy=True)
            for i, p in enumerate(prompts):
                eng.submit(i, p, max_new=4)
            eng.step()
            resident[share] = sum(r is not None for r in eng.active)
            res = eng.run()
            assert all(r.done for r in res.values())
            out.update({(share, i): list(r.out) for i, r in res.items()})
            engines[share] = eng
        return out, engines[True], (resident, engines[False].stats[
            "preemptions"], engines[False].stats["peak_pages"])

    eng, out = _both(weights, KW, 1, scenario)
    assert all(out[(True, i)] == out[(False, i)] for i in range(8))
    assert eng.stats["peak_pages"] <= 8 + 8
    assert eng.stats["prefix_hit_blocks"] >= 7 * 8
    _drained(eng)


@pytest.mark.parametrize("kv_pages,prefix", [(8, False), (8, True),
                                             (4, False)])
def test_preemption_liveness_pool_below_demand(weights, kv_pages, prefix):
    """tests/test_serve_prefix.py:238: a pool below aggregate demand
    drains every request through evict / preempt / requeue with one
    program shape."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 128, size=(6,)).astype(np.int32)
               for _ in range(5)]

    def scenario(make, sched):
        out, eng = _serve_all(make, prompts, 10, slots=4, max_len=64,
                              paged=True, page_size=4, kv_pages=kv_pages,
                              lazy=True, prefix_cache=prefix)
        return out, eng, None

    eng, _ = _both(weights, KW, 1, scenario)
    assert eng.stats["preemptions"] >= 1
    assert eng.stats["decode_traces"] == 1
    _drained(eng)


def test_lazy_reserve_clamped_to_worst_case(weights):
    """tests/test_serve_prefix.py:263: a max_new=1 request with a
    page-aligned prompt needs no decode page, so it drains on a one-page
    pool."""
    prompt = np.arange(16, dtype=np.int32)

    def scenario(make, sched):
        eng = make(slots=1, max_len=32, paged=True, page_size=16,
                   kv_pages=1, lazy=True)
        eng.submit(0, prompt, max_new=1)
        res = eng.run(max_steps=50)
        assert res[0].done
        return _streams(res), eng, None

    _drained(_both(weights, KW, 1, scenario)[0])


def test_preempted_partials_survive_max_steps(weights):
    """tests/test_serve_prefix.py:280: preempted and requeued requests
    surface as done=False partials when max_steps runs out, and a later
    run() finishes them."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 128, size=(5,)) for _ in range(3)]

    def scenario(make, sched):
        eng = make(slots=2, max_len=64, paged=True, page_size=4,
                   kv_pages=4, lazy=True)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=12)
        cut = eng.run(max_steps=4)
        notes = {i: (r.done, list(r.out)) for i, r in cut.items()}
        assert set(cut) == {0, 1, 2}
        assert any(not r.done for r in cut.values())
        res = eng.run()
        assert all(r.done for r in res.values())
        return _streams(res), eng, notes

    _drained(_both(weights, KW, 1, scenario)[0])


def test_scheduler_policy_object():
    """tests/test_serve_prefix.py:299 on the port's copy."""
    sched = port_sched.FifoLeastProgress()
    assert sched.next_index([]) is None
    assert sched.next_index(["a", "b"]) == 0
    assert sched.pick_victim([(0, 5), (1, 2), (2, 2)]) == 1
    assert sched.pick_victim([(3, 0)]) == 3
    with pytest.raises(ValueError):
        sched.pick_victim([])
    q = deque(["x"])
    sched.requeue(q, "victim")
    assert list(q) == ["victim", "x"]


def test_prefix_and_lazy_flag_validation(weights):
    """tests/test_serve_prefix.py:314: prefix_cache / lazy resolve
    ``paged=None`` to the pool and refuse the dense layout and the SSM
    family."""
    _, _, _, params = weights(KW, 1)
    eng = ServeEngine(CFG, params, slots=1, max_len=32, prefix_cache=True)
    assert eng.paged and eng.prefix_cache
    for flag in ("prefix_cache", "lazy"):
        with pytest.raises(ValueError, match="paged"):
            ServeEngine(CFG, params, slots=1, max_len=32, paged=False,
                        **{flag: True})
    ssm = ModelConfig(name="prefix-ssm", arch_type="ssm", num_layers=2,
                      d_model=64, num_heads=0, num_kv_heads=0, d_ff=128,
                      ssm_state=16, ssm_heads=4, ssm_head_dim=16,
                      vocab_size=128, dtype="float32")
    with pytest.raises(ValueError, match="paged KV"):
        ServeEngine(ssm, None, slots=1, max_len=32, prefix_cache=True,
                    device="cpu")


def test_session_serve_wires_prefix_and_lazy(weights):
    """tests/test_serve_prefix.py:334: ``Session.serve`` passes
    prefix_cache / lazy through; its streams equal the JAX engine's and
    the session's own generate."""
    _, _, _, params = weights(KW, 1)
    session = Session(CFG, device="cpu", params=params)
    prompts = _system_prompts(7, 16, (3, 5))

    def scenario(make, sched):
        out, eng = _serve_all(make, prompts, 4, slots=2, max_len=64,
                              page_size=8, prefix_cache=True, lazy=True)
        return out, eng, None

    _both(weights, KW, 1, scenario)
    eng = session.serve(slots=2, max_len=64, page_size=8,
                        prefix_cache=True, lazy=True)
    assert eng.paged and eng.prefix_cache and eng.lazy
    for i, p in enumerate(prompts):
        eng.submit(i, p, max_new=4)
    res = eng.run()
    for i, p in enumerate(prompts):
        ref = session.generate(p, steps=4)[0]
        assert res[i].out == [int(t) for t in ref]
    assert eng.stats["prefix_hit_blocks"] >= 2
    _drained(eng)


def test_mixed_matches_split_prefix_cache_lazy(weights):
    """tests/test_serve_mixed.py:128: a shared system prompt and lazy
    growth on 4 slots: the mixed step (donor / dependent chunked prefill
    over shared pages) and the split path give the JAX engine's streams,
    and sharing collapses the system prompt on the mixed path too."""
    prompts = _system_prompts(3, 33, (5, 9, 3, 14))
    stats = {}

    def scenario(make, sched):
        out = {}
        for mixed in (False, True):
            got, eng = _serve_all(make, prompts, 5, slots=4, max_len=64,
                                  paged=True, mixed=mixed,
                                  chunk_tokens=16 if mixed else 256,
                                  prefix_cache=True, lazy=True)
            out.update({(mixed, i): v for i, v in got.items()})
            stats[mixed] = eng.stats["prefix_hit_blocks"]
        return out, eng, dict(stats)

    eng, out = _both(weights, MIXED_KW, 0, scenario)
    assert all(out[(True, i)] == out[(False, i)] for i in range(4))
    assert stats[True] >= stats[False]
    _drained(eng)


def test_priority_admission_order(weights):
    """tests/test_serve_engine.py:405: with one slot the highest-priority
    request is admitted first; streams as the JAX engine's."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 128, size=(6,)).astype(np.int32)
               for _ in range(3)]

    def scenario(make, sched):
        eng = make(slots=1, max_len=64, scheduler=sched.Priority())
        for i, pri in enumerate((0, 5, 1)):
            eng.submit(i, prompts[i], max_new=4, priority=pri)
        eng.step()
        first = eng.active[0].rid
        res = eng.run()
        assert all(r.done for r in res.values())
        return _streams(res), eng, first

    eng, _ = _both(weights, KW, 0, scenario)
    assert eng.finished[1].first_tok_t < eng.finished[2].first_tok_t \
        < eng.finished[0].first_tok_t
    _drained(eng)


def test_priority_preempts_lowest_priority_first(weights):
    """tests/test_serve_engine.py:427: lazy growth on a 6-page pool with
    the Priority policy preempts the low-priority slot although it has
    more progress, and everything drains."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 128, size=(6,)).astype(np.int32)
               for _ in range(2)]

    def scenario(make, sched):
        eng = make(slots=2, max_len=64, paged=True, page_size=4,
                   kv_pages=6, lazy=True, scheduler=sched.Priority())
        victims = []
        orig = eng._preempt

        def spy(s):
            victims.append(eng.active[s].rid)
            orig(s)

        eng._preempt = spy
        eng.submit(0, prompts[0], max_new=10, priority=0)
        for _ in range(5):
            eng.step()
        assert eng.active[0] is not None and len(eng.active[0].out) > 1
        eng.submit(1, prompts[1], max_new=10, priority=9)
        res = eng.run()
        assert all(r.done for r in res.values())
        return _streams(res), eng, victims

    eng, _ = _both(weights, KW, 0, scenario)
    assert eng.stats["preemptions"] >= 1
    _drained(eng)


def test_public_preempt_resumes_with_the_same_stream(weights):
    """``preempt(s)`` (the online driver's recovery) mid-decode and
    mid-prefill on both paths: the request resumes by re-prefilling
    ``prompt + out`` and its stream equals the JAX engine's (which is
    the uninterrupted one); an empty slot refuses."""
    prompts = _system_prompts(13, 20, (7, 30))

    def scenario(make, sched):
        out = {}
        for mixed in (True, False):
            eng = make(slots=2, max_len=64, paged=True, mixed=mixed,
                       chunk_tokens=16, prefix_cache=True)
            for i, p in enumerate(prompts):
                eng.submit(i, p, max_new=8)
            for _ in range(3):
                eng.step()
            for s in range(2):
                if eng.active[s] is not None:
                    eng.preempt(s)
            with pytest.raises(ValueError, match="no active request"):
                eng.preempt(0)
            res = eng.run()
            assert all(r.done for r in res.values())
            out.update({(mixed, i): list(r.out) for i, r in res.items()})
        return out, eng, None

    eng, out = _both(weights, KW, 0, scenario)
    assert all(out[(True, i)] == out[(False, i)] for i in range(2))
    assert eng.stats["preemptions"] >= 1
    _drained(eng)
