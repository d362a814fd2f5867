"""Speculative decode in the port's ``ServeEngine``, held to the JAX engine
on the CPU.

Every dense case of tests/test_serve_spec.py runs the same traffic through
the JAX engine and the port's with the same keywords on the same weights
(JAX-initialised, bridged) and shows: the port's spec streams equal the
JAX engine's spec streams, the drafted/accepted counters and the program
shape counts are equal (host logic and argmax tokens, so exactly), and
the reference test's own assertions hold on the port (spec on == spec
off, more than one token per (step, slot) on repetitive prompts, EOS and
``max_new`` inside an accepted draft, rollback bookkeeping, prefix pages
intact), and the dp 2 router with spec on (tests/test_serve_spec.py:231).
The reference's MoE and enc-dec spec cases are in
tests/test_torch_moe_serve.py and tests/test_torch_encdec_serve.py; the
spec runs at tp 2 and dp 2 x tp 2 are in tests/test_torch_tp.py and
tests/test_torch_parallel.py (rank processes).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.serve import speculative as jax_spec  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.params import from_numpy, init_params  # noqa: E402
from repro_torch.serve import speculative as spec_mod  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.paging import PageAllocator  # noqa: E402
from repro_torch.serve.parallel import ReplicaRouter  # noqa: E402
from repro_torch.serve.speculative import (DraftModelDrafter,  # noqa: E402
                                           NgramDrafter, SpecConfig)

#: tests/test_serve_spec.py's CFG
KW = dict(name="spec-dense", arch_type="dense", num_layers=2, d_model=64,
          num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
          dtype="float32")
CFG = ModelConfig(**KW)
SPEC_K = 4

#: counters a case holds equal to the JAX engine's
COUNTERS = ("spec_drafted", "spec_accepted", "decode_steps",
            "decode_slot_steps", "decode_tokens", "prefills",
            "decode_traces", "prefill_traces", "prefix_hit_blocks",
            "cow_copies", "preemptions", "peak_pages")


@pytest.fixture(scope="module")
def weights():
    """JAX params of the case's config and their bridge into the port."""
    jcfg = JaxConfig(**KW)
    jp = get_model(jcfg).init(jax.random.key(0), jcfg)
    return jcfg, jp, from_numpy(_flatten(jp), CFG, "cpu")


def _prompts(rng, lens, vocab=128):
    return [rng.integers(0, vocab, size=(int(n),)).astype(np.int32)
            for n in lens]


def _repetitive_prompts(rng, n_prompts, vocab=128):
    """Tiled short motifs (tests/test_serve_spec.py::_repetitive_prompts)."""
    out = []
    for _ in range(n_prompts):
        motif = rng.integers(0, vocab, size=(int(rng.integers(3, 6)),))
        out.append(np.tile(motif, int(rng.integers(4, 7))).astype(np.int32))
    return out


def _serve(make, prompts, new, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk_tokens", 16)
    eng = make(paged=True, mixed=True, **kw)
    for i, p in enumerate(prompts):
        eng.submit(i, p, max_new=new)
    res = eng.run()
    assert all(r.done for r in res.values())
    return {i: list(res[i].out) for i in res}, eng


def _both(weights, prompts, new, *, spec=None, jspec=None, **kw):
    """Serve ``prompts`` on the JAX engine and the port's with the same
    keywords (``spec``: the port's SpecConfig keywords, or None); assert
    equal streams and counters; return the port's streams and engine."""
    jcfg, jp, tp = weights
    jspec_obj = None if spec is None else jax_spec.SpecConfig(
        **{**spec, **(jspec or {})})
    pspec = None if spec is None else SpecConfig(**spec)
    want, jeng = _serve(lambda **e: JaxEngine(jcfg, jp, spec=jspec_obj, **e),
                        prompts, new, **kw)
    got, eng = _serve(lambda **e: ServeEngine(CFG, tp, spec=pspec, **e),
                      prompts, new, **kw)
    assert got == want
    for key in COUNTERS:
        assert eng.stats[key] == jeng.stats[key], key
    return got, eng


def _drained(eng):
    assert all(r is None for r in eng.active) and not eng.queue
    eng.release_prefix_cache()
    assert eng._alloc.pages_in_use == 0
    assert eng._alloc.free_pages == eng._alloc.num_pages
    assert list(eng._alloc.owners()) == []


# ------------------------------------------------------- drafter units

def test_ngram_drafter_matches_most_recent_longest():
    d = NgramDrafter(ngram_min=1, ngram_max=4)
    ref = jax_spec.NgramDrafter(ngram_min=1, ngram_max=4)
    for ctx, k, want in (([1, 2, 3, 4, 1, 2, 3], 2, [4, 1]),
                         ([7, 8, 7, 9, 7], 3, [9, 7]),
                         ([5, 6, 5], 4, [6, 5])):
        got = d.propose(np.array(ctx), k)
        assert got.tolist() == want == ref.propose(np.array(ctx), k).tolist()


def test_ngram_drafter_no_match_is_empty():
    d = NgramDrafter()
    assert d.propose(np.array([1, 2, 3]), 4).size == 0
    assert d.propose(np.array([9]), 4).size == 0
    d2 = NgramDrafter(ngram_min=3, ngram_max=4)
    assert d2.propose(np.array([7, 8, 7, 9, 7]), 3).size == 0
    with pytest.raises(ValueError, match="ngram_min"):
        NgramDrafter(ngram_min=0)


def test_draft_model_drafter_is_own_greedy_chain(weights):
    """With the verifier's own params the port's draft model proposes its
    teacher-forced greedy continuation — the JAX drafter's proposals on
    the same params — and clamps k to its max_len headroom."""
    jcfg, jp, tp = weights
    d = DraftModelDrafter(CFG, tp, max_len=64)
    ref = jax_spec.DraftModelDrafter(jcfg, jp, max_len=64)
    ctx = _prompts(np.random.default_rng(0), (7,))[0]
    got = d.propose(ctx, 3)
    assert got.shape == (3,)
    assert got.tolist() == ref.propose(ctx, 3).tolist()
    run = list(ctx)
    for i in range(3):
        logits = transformer.forward(
            tp, {"tokens": torch.tensor([run], dtype=torch.int32)}, CFG)[0]
        t = int(torch.argmax(logits[0, -1]))
        assert int(got[i]) == t
        run.append(t)
    assert d.propose(np.arange(62) % 128, 4).shape == (2,)


def test_draft_model_default_config_and_seeded_params():
    """Omitted draft config: the reference's one-layer fp32 dense model
    over the verifier's vocabulary; omitted params: drawn from a generator
    seeded with ``seed + draft_seed`` (same seeds, same params)."""
    spec = SpecConfig(k=2, drafter="model", draft_seed=3)
    a = spec_mod.make_drafter(spec, CFG, max_len=64, seed=1)
    b = spec_mod.make_drafter(spec, CFG, max_len=64, seed=1)
    c = spec_mod.make_drafter(spec, CFG, max_len=64, seed=2)
    dc = a.cfg
    assert (dc.arch_type, dc.num_layers, dc.d_model, dc.num_heads,
            dc.num_kv_heads, dc.d_ff, dc.vocab_size, dc.dtype) == \
        ("dense", 1, 64, 2, 2, 128, CFG.vocab_size, "float32")
    want = init_params(dc, device="cpu", seed=4)["embed"]
    assert torch.equal(a.params["embed"], want)
    assert torch.equal(b.params["embed"], want)
    assert not torch.equal(c.params["embed"], want)
    with pytest.raises(ValueError, match="vocab"):
        spec_mod.make_drafter(
            SpecConfig(drafter="model", draft_cfg=dc.with_(vocab_size=64)),
            CFG, max_len=64)
    with pytest.raises(ValueError, match="dense decoder"):
        DraftModelDrafter(dc.with_(arch_type="ssm"), max_len=64)


def test_spec_config_validation():
    with pytest.raises(ValueError, match="spec.k"):
        SpecConfig(k=0)
    with pytest.raises(ValueError, match="drafter"):
        SpecConfig(drafter="oracle")
    with pytest.raises(ValueError, match="ngram_min"):
        SpecConfig(ngram_min=3, ngram_max=2)


@pytest.mark.parametrize("kw,match", [
    (dict(mixed=False), "mixed"),
    (dict(temperature=0.7, chunk_tokens=32), "greedy"),
    (dict(slots=4, chunk_tokens=8), "chunk_tokens"),
])
def test_engine_rejects_bad_spec_combinations(weights, kw, match):
    """The reference's constructor checks, with its text: the same
    keywords raise the same ValueError on both engines."""
    jcfg, jp, tp = weights
    for engine, conf, params, spec in (
            (JaxEngine, jcfg, jp, jax_spec.SpecConfig(k=SPEC_K)),
            (ServeEngine, CFG, tp, SpecConfig(k=SPEC_K))):
        with pytest.raises(ValueError, match=match):
            engine(conf, params, paged=True, spec=spec, **kw)


def test_engine_on_cuda_refuses_draft_model_limits(weights):
    """On a CUDA device the engine checks, at construction, the kernels
    the draft model's forward launches (no card needed to refuse)."""
    from repro_torch import kernels
    _, _, tp = weights
    kernels.reset_launches()
    draft = CFG.with_(name="odd-draft", dtype="bfloat16", d_ff=100)
    with pytest.raises(ValueError, match="draft model odd-draft.*fused-MLP"):
        ServeEngine(CFG, tp, device="cuda", spec=SpecConfig(
            drafter="model", draft_cfg=draft))
    assert sum(kernels.launches().values()) == 0


# ------------------------------------------------- greedy bit-identity

def test_spec_matches_plain_dense_multislot(weights):
    rng = np.random.default_rng(0)
    prompts = _prompts(rng, (5, 23, 9)) + _repetitive_prompts(rng, 2)
    plain, pe = _both(weights, prompts, 8)
    spec, se = _both(weights, prompts, 8, spec=dict(k=SPEC_K))
    assert spec == plain
    assert se.stats["spec_drafted"] > 0
    # draft rows ride the one mixed program: no extra program shapes
    assert se.stats["prefill_traces"] == 0
    assert se.stats["decode_traces"] <= 2
    assert se.stats["decode_traces"] == pe.stats["decode_traces"]


def test_spec_matches_plain_prefix_cache_lazy(weights):
    """Shared system prompt + lazy growth: draft writes land on
    extend-fresh private pages, so the shared prefix stays intact."""
    rng = np.random.default_rng(3)
    system = rng.integers(0, 128, size=(33,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 128, size=(int(n),))])
               .astype(np.int32) for n in (5, 9, 3, 14)]
    kw = dict(slots=4, prefix_cache=True, lazy=True, chunk_tokens=24)
    plain, pe = _both(weights, prompts, 6, **kw)
    spec, se = _both(weights, prompts, 6, spec=dict(k=SPEC_K), **kw)
    assert spec == plain
    assert se.stats["spec_drafted"] > 0
    assert se.stats["prefix_hit_blocks"] >= pe.stats["prefix_hit_blocks"]
    assert se.stats["decode_traces"] == pe.stats["decode_traces"]
    _drained(se)


def test_spec_matches_plain_tp2_dp2(weights):
    """tests/test_serve_spec.py:231's router half on the port: a dp 2
    router with spec on (k 4) streams the JAX engine's plain streams and
    drafts; its replicas draft on their own requests' contexts. (The tp 2
    half: tests/test_torch_tp.py's ``spec`` run on two gloo ranks.)"""
    rng = np.random.default_rng(7)
    prompts = _prompts(rng, (5, 21)) + _repetitive_prompts(rng, 2)
    plain, _ = _both(weights, prompts, 6)
    router = ReplicaRouter(CFG, weights[2], dp=2, devices=["cpu"] * 2,
                           slots=2, max_len=64, paged=True, mixed=True,
                           chunk_tokens=16, spec=SpecConfig(k=SPEC_K))
    for i, p in enumerate(prompts):
        router.submit(i, p, max_new=6)
    res = router.run()
    assert {i: list(res[i].out) for i in res} == plain
    assert router.stats["spec_drafted"] > 0
    assert all(r["decode_traces"] == 1 for r in router.stats["replicas"])


def test_spec_matches_plain_pallas_backend(weights):
    """The reference's case on its Pallas backend (interpret mode on the
    CPU): the port's plain path on the CPU gives its streams, spec on and
    off."""
    jcfg, jp, tp = weights
    rng = np.random.default_rng(11)
    prompts = _prompts(rng, (5, 17)) + _repetitive_prompts(rng, 2)
    jspec = jax_spec.SpecConfig(k=SPEC_K)
    ref, je = _serve(lambda **e: JaxEngine(jcfg, jp, attn_backend="pallas",
                                           spec=jspec, **e), prompts, 6)
    assert je.stats["decode_backend"] == "pallas"
    plain, _ = _serve(lambda **e: ServeEngine(CFG, tp, **e), prompts, 6)
    spec, se = _serve(lambda **e: ServeEngine(
        CFG, tp, spec=SpecConfig(k=SPEC_K), **e), prompts, 6)
    assert spec == plain == ref
    assert se.stats["spec_drafted"] == je.stats["spec_drafted"] > 0
    assert se.stats["decode_backend"] == "plain"


# ------------------------------------------------ speedup + accounting

def test_repetitive_context_accepts_multiple_tokens_per_step(weights):
    rng = np.random.default_rng(4)
    prompts = _repetitive_prompts(rng, 4)
    plain, pe = _both(weights, prompts, 16)
    spec, se = _both(weights, prompts, 16, spec=dict(k=SPEC_K))
    assert spec == plain

    def per_slot_step(st):
        return (st["decode_tokens"] - st["prefills"]) / \
            max(st["decode_slot_steps"], 1)

    assert per_slot_step(pe.stats) == pytest.approx(1.0)
    assert per_slot_step(se.stats) > 1.0
    assert se.stats["spec_accepted"] > 0
    assert se.stats["decode_steps"] < pe.stats["decode_steps"]


def test_tracer_notes_drafted_and_accepted(weights):
    """The step records and the level-2 request details carry the
    drafted/accepted counts (0 without speculation)."""
    _, _, tp = weights
    prompts = _repetitive_prompts(np.random.default_rng(4), 2)
    _, se = _serve(lambda **e: ServeEngine(
        CFG, tp, spec=SpecConfig(k=SPEC_K), trace_level=2, **e), prompts, 12)
    flight = se.tracer.flight()
    work = [w for rec in flight["steps"] for w in rec["work"]
            if w["kind"] == "decode"]
    assert sum(w.get("drafted", 0) for w in work) == \
        se.stats["spec_drafted"] > 0
    assert sum(w.get("accepted_drafts", 0) for w in work) == \
        se.stats["spec_accepted"] > 0
    details = [e for r in flight["finished_requests"]
               for e in r["events"] if e["kind"] == "decode"]
    assert sum(e["drafted"] for e in details) == se.stats["spec_drafted"]
    assert sum(e["accepted"] for e in details) == se.stats["spec_accepted"]


# ------------------------------------------------- stop-condition edges

def test_eos_inside_accepted_draft(weights):
    """Self-drafting with the verifier's own params: EOS lands inside an
    accepted draft and the output stops exactly there, as without
    speculation and as on the JAX engine."""
    jcfg, jp, tp = weights
    prompts = _prompts(np.random.default_rng(9), (6,))
    base, _ = _both(weights, prompts, 14)
    eos, at = None, None
    for idx in range(2, len(base[0])):
        if base[0].index(base[0][idx]) == idx:
            eos, at = base[0][idx], idx
            break
    assert eos is not None, "degenerate greedy chain"
    spec = dict(k=SPEC_K, drafter="model", draft_cfg=CFG, draft_params=tp)
    jspec = dict(draft_cfg=jcfg, draft_params=jp)
    plain, _ = _both(weights, prompts, 14, eos_id=eos)
    specr, se = _both(weights, prompts, 14, eos_id=eos, spec=spec,
                      jspec=jspec)
    assert specr == plain
    assert specr[0] == base[0][:at + 1]
    assert se.stats["spec_accepted"] > 0


@pytest.mark.parametrize("new", [2, 3, 7])
def test_max_new_inside_accepted_draft(weights, new):
    jcfg, jp, tp = weights
    prompts = _prompts(np.random.default_rng(10), (5, 8))
    spec = dict(k=SPEC_K, drafter="model", draft_cfg=CFG, draft_params=tp)
    jspec = dict(draft_cfg=jcfg, draft_params=jp)
    plain, _ = _both(weights, prompts, new)
    specr, _ = _both(weights, prompts, new, spec=spec, jspec=jspec)
    assert specr == plain
    assert all(len(o) == new for o in specr.values())


# --------------------------------------------- rollback page bookkeeping

def test_rejection_rollback_across_page_boundary_drains_clean(weights):
    rng = np.random.default_rng(7)
    prompts = _prompts(rng, (5, 11, 7)) + _repetitive_prompts(rng, 2)
    kw = dict(slots=2, lazy=True, page_size=4, max_len=64)
    plain, _ = _both(weights, prompts, 10, **kw)
    spec, se = _both(weights, prompts, 10, spec=dict(k=SPEC_K), **kw)
    assert spec == plain
    assert se.stats["spec_drafted"] > se.stats["spec_accepted"]
    _drained(se)


def test_drafts_on_cow_shared_pages_leave_prefix_intact(weights):
    rng = np.random.default_rng(8)
    system = np.tile(rng.integers(0, 128, size=(4,)), 5).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 128, size=(int(n),))])
               .astype(np.int32) for n in (3, 6, 4)]
    kw = dict(slots=3, prefix_cache=True, lazy=True, page_size=4,
              chunk_tokens=24, max_len=64)
    plain, _ = _both(weights, prompts, 8, **kw)
    spec, se = _both(weights, prompts, 8, spec=dict(k=SPEC_K), **kw)
    assert spec == plain
    assert se.stats["spec_drafted"] > 0
    assert se.stats["prefix_hit_blocks"] > 0
    _drained(se)


def test_allocator_rollback_drops_private_tail():
    a = PageAllocator(8, 4)
    a.alloc("s", 10)
    assert a.free_pages == 5
    dropped = a.rollback("s", 5)
    assert len(dropped) == 1 and a.free_pages == 6
    assert len(a.pages_of("s")) == 2
    assert a.extend("s", 10) is not None
    assert a.free_pages == 5


def test_allocator_rollback_len_only_shrink():
    a = PageAllocator(8, 4)
    a.alloc("s", 10)
    assert a.rollback("s", 9) == []
    assert len(a.pages_of("s")) == 3
    assert a.extend("s", 12) == []


def test_allocator_rollback_shared_page_stays_live():
    a = PageAllocator(4, 4)
    [p] = a.alloc("s", 4)
    a.ref(p)
    assert a.rollback("s", 0) == [p]
    assert a.free_pages == 3
    a.deref(p)
    assert a.free_pages == 4


def test_allocator_rollback_errors():
    a = PageAllocator(4, 4)
    with pytest.raises(KeyError):
        a.rollback("nobody", 0)
    a.alloc("s", 4)
    with pytest.raises(ValueError, match="use extend"):
        a.rollback("s", 9)
    assert a.rollback("s", 4) == []
