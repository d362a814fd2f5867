"""The port's serving stack on the CPU (repro_torch/{serve,api,launch}).

Every layout of the engine is held to the JAX ``ServeEngine`` with the
same keywords: identical greedy token streams on the same weights and
prompts — the paged mixed step (tests/test_serve_mixed.py:86), the split
prefill/decode path on the pool (``mixed=False``) and on the dense layout
(``paged=False``), and the sliding-window ring
(tests/test_serve_engine.py:118) — and the same streams across the
port's layouts; ``greedy_generate`` and ``Session.generate`` to the
reference's generate loop. Plus the engine's own contracts
(max_new=1, decode never stalled by a long prefill, bounded program
shapes), the not-yet-ported features raising, the Session and launcher
on ``device="cpu"``, the rule that the port imports no JAX, and
chip_smoke.py refusing to run without a card or without the repo.
"""
import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.step import greedy_generate as jax_generate  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.params import from_numpy, init_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.step import greedy_generate  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KW = dict(name="mixed-dense", arch_type="dense", num_layers=2, d_model=64,
          num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
          dtype="float32")
CFG = ModelConfig(**KW)


@pytest.fixture(scope="module")
def weights():
    """JAX-initialised params and their bridge into the port (CPU)."""
    jcfg = JaxConfig(**KW)
    jparams = get_model(jcfg).init(jax.random.key(0), jcfg)
    return jcfg, jparams, from_numpy(_flatten(jparams), CFG, "cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=(int(n),)).astype(np.int32)
            for n in lens]


def _serve(params, prompts, new, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk_tokens", 16)
    eng = ServeEngine(CFG, params, **kw)
    for i, p in enumerate(prompts):
        eng.submit(i, p, max_new=new)
    res = eng.run()
    return {i: list(res[i].out) for i in res}, eng


#: the reference engine's keywords of each layout the port serves
LAYOUTS = {"mixed": dict(paged=True, mixed=True, chunk_tokens=16),
           "split": dict(mixed=False), "dense": dict(paged=False)}
PROMPTS = _prompts(0, (5, 23, 9, 40, 6))


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engine's greedy streams and stats on PROMPTS, a layout a
    key (slots 2, max_len 64, 6 new tokens each)."""
    jcfg, jparams, _ = weights
    out = {}
    for name, kw in LAYOUTS.items():
        jeng = JaxEngine(jcfg, jparams, slots=2, max_len=64, **kw)
        for i, p in enumerate(PROMPTS):
            jeng.submit(i, p, max_new=6)
        jres = jeng.run()
        out[name] = ({i: list(jres[i].out) for i in jres}, jeng.stats)
    return out


def test_greedy_streams_match_jax_mixed_engine(weights, jax_streams):
    _, _, params = weights
    want, jstats = jax_streams["mixed"]
    got, eng = _serve(params, PROMPTS, 6)
    assert got == want
    assert all(r.done for r in eng.finished.values())
    for key in ("prefills", "decode_tokens", "prefill_chunk_tokens",
                "decode_steps", "decode_slot_steps", "peak_pages",
                "decode_traces", "prefill_traces"):
        assert eng.stats[key] == jstats[key], key
    assert eng.stats["decode_backend"] == "plain"
    assert eng.stats["mixed_steps"] >= eng.stats["decode_steps"]
    # pages are all returned; the tracer saw every request complete
    assert eng.stats["pages_in_use"] == 0
    assert len(eng.trace()["traceEvents"]) > 0


@pytest.mark.parametrize("layout", ["split", "dense"])
def test_split_path_streams_match_jax_engine(weights, jax_streams, layout):
    """The split prefill/decode path on the pool (``mixed=False``) and on
    the dense layout (``paged=False``): the JAX engine's streams with the
    same keywords, its trace counts (distinct padded prefill lengths, one
    decode shape), and the port's mixed engine's streams."""
    _, _, params = weights
    want, jstats = jax_streams[layout]
    kw = LAYOUTS[layout]
    got, eng = _serve(params, PROMPTS, 6, **kw)
    assert got == want == jax_streams["mixed"][0]
    assert eng.paged == (layout == "split") and not eng.mixed
    assert all(r.done for r in eng.finished.values())
    for key in ("prefills", "decode_tokens", "decode_steps",
                "decode_slot_steps", "peak_pages", "decode_traces",
                "prefill_traces"):
        assert eng.stats[key] == jstats[key], key
    assert eng.stats["prefill_traces"] == 4   # buckets 8, 16, 32 and 64
    assert eng.stats["decode_traces"] == 1
    assert eng.stats["pages_in_use"] == 0
    mixed, _ = _serve(params, PROMPTS, 6)
    assert got == mixed


SWA_KW = dict(KW, name="engine-swa", sliding_window=8)


def test_swa_ring_streams_match_jax_engine_and_generate():
    """tests/test_serve_engine.py:118 on the port: a sliding-window config
    serves on the dense ring (window 8, prompts 5, 13 and 9, crossing and
    straddling it) with the JAX engine's streams, each equal to the
    request decoded alone by the port's ``greedy_generate``."""
    jcfg = JaxConfig(**SWA_KW)
    jparams = get_model(jcfg).init(jax.random.key(3), jcfg)
    cfg = ModelConfig(**SWA_KW)
    params = from_numpy(_flatten(jparams), cfg, "cpu")
    prompts = _prompts(3, (5, 13, 9))
    jeng = JaxEngine(jcfg, jparams, slots=2, max_len=32)
    eng = ServeEngine(cfg, params, slots=2, max_len=32)
    assert not eng.paged and not eng.mixed
    assert eng._cache["kv"]["k"].shape[2] == 8          # the ring
    for e in (jeng, eng):
        for i, p in enumerate(prompts):
            e.submit(i, p, max_new=6)
    want = {i: list(r.out) for i, r in jeng.run().items()}
    got = {i: list(r.out) for i, r in eng.run().items()}
    assert got == want
    for i, p in enumerate(prompts):
        alone = greedy_generate(params, cfg, None,
                                {"tokens": torch.from_numpy(p[None])}, 6)
        assert alone[0].tolist() == got[i]
    for key in ("decode_traces", "prefill_traces", "prefills",
                "decode_steps"):
        assert eng.stats[key] == jeng.stats[key], key


def test_swa_paged_raises_the_reference_value_error():
    """A sliding-window config is not pageable: ``paged=True`` raises the
    reference's ValueError, word for word but for the list of pageable
    families, which names the ported ones."""
    from repro.serve.engine import PAGEABLE_ARCHS as JAX_PAGEABLE
    from repro_torch.serve.engine import PAGEABLE_ARCHS
    jcfg, cfg = JaxConfig(**SWA_KW), ModelConfig(**SWA_KW)
    with pytest.raises(ValueError) as want:
        JaxEngine(jcfg, {}, paged=True)
    with pytest.raises(ValueError) as got:
        ServeEngine(cfg, {"embed": torch.zeros(1)}, paged=True)
    assert str(got.value) == str(want.value).replace(
        "/".join(JAX_PAGEABLE), "/".join(PAGEABLE_ARCHS))
    assert "SWA ring" in str(got.value)
    with pytest.raises(ValueError, match="prefix_cache/lazy"):
        ServeEngine(CFG, {"embed": torch.zeros(1)}, paged=False,
                    prefix_cache=True)


@pytest.mark.parametrize("steps", [1, 7])
def test_greedy_generate_matches_reference(weights, steps):
    """The lockstep generate loop (B 3, S 11) gives the reference's
    tokens."""
    jcfg, jparams, params = weights
    toks = np.stack(_prompts(8, (11, 11, 11)))
    want = np.asarray(jax_generate(jparams, jcfg, None,
                                   {"tokens": jax.numpy.asarray(toks)},
                                   steps=steps))
    got = greedy_generate(params, CFG, None,
                          {"tokens": torch.from_numpy(toks)}, steps)
    assert got.dtype == torch.int32 and got.shape == (3, steps)
    np.testing.assert_array_equal(got.numpy(), want)


def test_session_generate_and_seeded_sampling(weights):
    """``Session.generate`` on the CPU: a (s,) or (b, s) prompt, or a
    batch dict, gives the reference's greedy tokens; sampling with
    ``temperature > 0`` replays from one seed."""
    jcfg, jparams, params = weights
    toks = np.stack(_prompts(9, (9, 9)))
    want = np.asarray(jax_generate(jparams, jcfg, None,
                                   {"tokens": jax.numpy.asarray(toks)},
                                   steps=5))
    session = Session(CFG, device="cpu", params=params)
    np.testing.assert_array_equal(session.generate(toks, steps=5).numpy(),
                                  want)
    np.testing.assert_array_equal(
        session.generate({"tokens": toks}, steps=5).numpy(), want)
    np.testing.assert_array_equal(
        session.generate(toks[1], steps=5).numpy(), want[1:])
    draws = [greedy_generate(params, CFG, None,
                             {"tokens": torch.from_numpy(toks)}, 6,
                             temperature=1.0,
                             generator=torch.Generator().manual_seed(4))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert ((draws[0] >= 0) & (draws[0] < CFG.vocab_size)).all()


def test_engine_on_cuda_refuses_paged_shapes_at_construction(weights):
    """A bf16 paged engine asked for the card with a page size the
    paged-attention kernel cannot take raises ValueError naming the limit
    at construction — before ``submit`` could queue a request — and
    launches nothing (no card is needed to refuse); so does a dense split
    engine whose heads the flash kernel (every prefill) cannot take."""
    from repro_torch import kernels
    _, _, params = weights
    cfg = CFG.with_(dtype="bfloat16")
    kernels.reset_launches()
    for kw in (dict(page_size=4), dict(page_size=4, mixed=False)):
        with pytest.raises(ValueError, match=r"page sizes \(8, 16, 32, 64\)"):
            ServeEngine(cfg, params, device="cuda", **kw)
    odd = cfg.with_(head_dim=20)
    with pytest.raises(ValueError, match="flash-attention kernel"):
        ServeEngine(odd, params, device="cuda", paged=False)
    assert sum(kernels.launches().values()) == 0


@pytest.mark.parametrize("cfg_kw,eng_kw,match", [
    # f32 paged attention takes D <= 256, flash D <= 128: the paged split
    # path's prefills would refuse D = 160 at the first admission
    (dict(dtype="float32", head_dim=160), dict(mixed=False),
     "flash-attention kernel"),
    (dict(dtype="bfloat16", d_ff=100), {}, "fused-MLP kernel"),
    (dict(dtype="bfloat16", d_ff=100), dict(paged=False), "fused-MLP kernel"),
])
def test_engine_on_cuda_refuses_each_kernel_of_its_path(weights, cfg_kw,
                                                        eng_kw, match):
    """On a CUDA device the engine checks, at construction, the limits of
    every kernel its path launches (no card needed to refuse): flash
    attention on the paged split path too, and the fused MLP on every
    dense path."""
    from repro_torch import kernels
    _, _, params = weights
    kernels.reset_launches()
    with pytest.raises(ValueError, match=match):
        ServeEngine(CFG.with_(**cfg_kw), params, device="cuda", **eng_kw)
    assert sum(kernels.launches().values()) == 0


def _alone(params, prompt, new):
    """The request decoded alone by the lockstep loop (held to the
    reference's by test_greedy_generate_matches_reference)."""
    toks = greedy_generate(params, CFG, None,
                           {"tokens": torch.from_numpy(prompt[None])}, new)
    return toks[0].tolist()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case", ["capacity", "prompt_at_capacity",
                                  "max_new_one", "eos_on_prefill",
                                  "eos_mid_decode", "max_steps"])
def test_edge_cases_on_every_layout(weights, layout, case):
    """tests/test_serve_engine.py:180-285 on each of the port's layouts:
    a request bound by max_len (12) gets prefill token + one a free
    position, a prompt at max_len - 1 gets two; max_new 1 and EOS on the
    prefill token finish at admission with no decode; EOS mid-decode cuts
    the stream after it; ``run(max_steps=3)`` returns partial and queued
    records (3 tokens on the mixed step, 4 on the split path) and a later
    ``run()`` finishes both. Streams equal the request decoded alone."""
    _, _, params = weights
    kw = dict(LAYOUTS[layout], slots=1, max_len=12 if "capacity" in case
              else 64)
    kw.setdefault("chunk_tokens", 16)
    prompt = np.arange(11 if case == "prompt_at_capacity" else 8,
                       dtype=np.int32)
    if case in ("capacity", "prompt_at_capacity"):
        eng = ServeEngine(CFG, params, **kw)
        eng.submit(0, prompt, max_new=100)
        out = eng.run()[0]
        assert out.done and len(out.out) == 12 - len(prompt) + 1
        assert out.out == _alone(params, prompt, len(out.out))
    elif case == "max_steps":
        eng = ServeEngine(CFG, params, **kw)
        eng.submit(0, prompt[:5], max_new=50)
        eng.submit(1, prompt[:6], max_new=50)
        res = eng.run(max_steps=3)
        assert not res[0].done and not res[1].done and res[1].out == []
        assert len(res[0].out) == (3 if eng.mixed else 4)
        res = eng.run()
        assert res[0].done and res[1].done
        assert res[0].out == _alone(params, prompt[:5], 50)
    else:
        ref = _alone(params, prompt, 10)
        eos = {"max_new_one": None, "eos_on_prefill": ref[0],
               "eos_mid_decode": ref[3]}[case]
        eng = ServeEngine(CFG, params, eos_id=eos, **kw)
        eng.submit(0, prompt, max_new=1 if case == "max_new_one" else 10)
        out = eng.run()[0]
        want = ref[:1] if eos is None else ref[:ref.index(eos) + 1]
        assert out.done and out.out == want
        if len(want) == 1:
            assert eng.stats["decode_steps"] == 0
    if eng.paged:
        assert eng.stats["pages_in_use"] == 0


def test_split_path_on_the_pool_waits_head_of_line(weights):
    """Backpressure on the paged split path: two requests of two pages
    each on a two-page pool — the second waits in the queue until the
    first retires, and both finish with the streams they get alone."""
    _, _, params = weights
    eng = ServeEngine(CFG, params, slots=2, max_len=48, kv_pages=2,
                      mixed=False)
    prompts = _prompts(5, (10, 10))
    for i, p in enumerate(prompts):
        eng.submit(i, p, max_new=10)
    eng.step()
    assert eng.active[1] is None and len(eng.queue) == 1
    res = eng.run()
    for i, p in enumerate(prompts):
        assert res[i].done and res[i].out == _alone(params, p, 10)
    assert eng.stats["peak_pages"] == 2 and eng.stats["pages_in_use"] == 0


def test_max_new_one_finishes_on_the_prefill_token(weights):
    _, _, params = weights
    prompts = _prompts(1, (7, 30, 3))
    out, eng = _serve(params, prompts, 1)
    assert all(len(v) == 1 for v in out.values())
    longer, _ = _serve(params, prompts, 4)
    assert all(longer[i][:1] == out[i] for i in out)
    assert eng.stats["decode_steps"] == 0 and eng.stats["prefills"] == 3


def test_long_prefill_never_stalls_decode(weights):
    """tests/test_serve_mixed.py:166 on the port: while a 40-token prompt
    prefills through an 8-token budget, the decoding slot gains one token
    every step, and the streams equal an uninterleaved run."""
    _, _, params = weights
    short, long = _prompts(11, (4, 40))
    eng = ServeEngine(CFG, params, slots=2, max_len=64, chunk_tokens=8)
    eng.submit(0, short, max_new=12)
    eng.step()
    eng.submit(1, long, max_new=4)
    chunk_steps = 0
    while eng.busy():
        before = len(eng.active[0].out) if eng.active[0] is not None else None
        pf = eng.stats["prefill_chunk_tokens"]
        eng.step()
        if eng.stats["prefill_chunk_tokens"] > pf:
            chunk_steps += 1
            if before is not None and eng.active[0] is not None:
                assert len(eng.active[0].out) == before + 1
    assert chunk_steps >= 5
    res = eng.results()
    ref, _ = _serve(params, [short, long], 12, chunk_tokens=8)
    assert list(res[0].out) == ref[0]
    solo, _ = _serve(params, [long], 4, chunk_tokens=8)
    assert list(res[1].out) == solo[0]


def test_program_shapes_bounded_by_page_buckets(weights):
    """tests/test_serve_mixed.py:208: ten prompt lengths, one token
    budget — the distinct program shapes stay <= 3 on this pool."""
    _, _, params = weights
    prompts = _prompts(13, (4, 6, 9, 12, 17, 21, 26, 33, 40, 47))
    out, eng = _serve(params, prompts, 4, slots=3)
    assert eng.stats["decode_traces"] <= 3
    assert eng.stats["prefill_traces"] == 0
    assert all(len(v) == 4 for v in out.values())


def test_sampling_greedy_ties_and_seeded_temperature(weights):
    """Greedy is the reference's argmax (first maximum wins); temperature
    draws follow softmax(logits / T) and replay from the same seed, in
    the sampler and through the engine."""
    from repro.serve.sampling import sample_tokens as jax_sample
    from repro_torch.serve.sampling import sample_tokens
    logits = np.array([[0.0, 3.0, 3.0, 1.0], [2.0, 2.0, 2.0, 2.0],
                       [-1.0, -5.0, 0.5, 0.25]], np.float32)
    greedy = sample_tokens(torch.from_numpy(logits))
    assert greedy.dtype == torch.int32
    assert greedy.tolist() == np.asarray(jax_sample(logits)).tolist() \
        == [1, 0, 2]
    row = torch.tensor([[0.0, 1.0, 2.0, -1.0]]).expand(4000, 4)
    gen = torch.Generator().manual_seed(5)
    draws = sample_tokens(row, generator=gen, temperature=2.0)
    freq = np.bincount(draws.numpy(), minlength=4) / 4000
    want = torch.softmax(row[0] / 2.0, dim=-1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.03)
    again = sample_tokens(row, generator=torch.Generator().manual_seed(5),
                          temperature=2.0)
    assert torch.equal(draws, again)
    _, _, params = weights
    prompts = _prompts(2, (5, 9, 14))
    a, _ = _serve(params, prompts, 5, temperature=1.0, seed=1)
    b, _ = _serve(params, prompts, 5, temperature=1.0, seed=1)
    assert a == b and all(len(v) == 5 for v in a.values())


def test_step_helpers_match_reference():
    """The port's copies of serve/step.py's host helpers give the JAX
    package's answers on seeded random inputs."""
    from repro.serve import step as jstep
    from repro_torch.serve import step
    rng = np.random.default_rng(7)
    for n in range(1, 300, 7):
        cap = int(rng.integers(0, 512))
        assert step.prefill_bucket(n, cap=cap) == \
            jstep.prefill_bucket(n, cap=cap)
        assert step.page_bucket(n, cap=max(cap, 1)) == \
            jstep.page_bucket(n, cap=max(cap, 1))
    for _ in range(200):
        budget = int(rng.integers(4, 64))
        decode = int(rng.integers(0, 5))
        items = []
        for s in range(int(rng.integers(0, 5))):
            n = int(rng.integers(1, 80))
            items.append({"slot": s, "n": n,
                          "cursor": int(rng.integers(0, n))})
        assert step.pack_token_budget(budget, decode, items) == \
            jstep.pack_token_budget(budget, decode, items)


def test_submit_validation_and_backpressure(weights):
    _, _, params = weights
    eng = ServeEngine(CFG, params, slots=2, max_len=48, kv_pages=2,
                      chunk_tokens=16)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(0, np.zeros(0, np.int32), max_new=2)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(0, np.zeros(48, np.int32), max_new=2)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(0, np.ones(3, np.int32), max_new=0)
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit(0, np.ones(30, np.int32), max_new=40)
    # two requests of 2 pages each on a 2-page pool: the second waits
    for i, p in enumerate(_prompts(5, (10, 10))):
        eng.submit(i, p, max_new=10)
    eng.step()
    assert eng.active[1] is None and len(eng.queue) == 1
    res = eng.run()
    assert all(res[i].done and len(res[i].out) == 10 for i in (0, 1))
    with pytest.raises(ValueError, match="chunk_tokens"):
        ServeEngine(CFG, params, slots=4, chunk_tokens=2)


@pytest.mark.parametrize("kw,item", [
    ({"planner": ()}, "item 12")])
def test_unported_engine_features_raise(weights, kw, item):
    """What is still missing raises naming its ROADMAP.md item.
    ``from_plan``, the planner's entry point, is ported: a one-chip plan's
    session serves the engine's streams (speculative decode, the earlier
    case here, is ported too; so are ``dryrun`` and ``lower``:
    tests/test_torch_dryrun.py; and serving on a ("pod", "data", "model")
    mesh: ``test_one_pod_mesh_serves_the_streams_without_pod``)."""
    from repro_torch.api import plan
    from repro_torch.configs.base import ShapeConfig
    _, _, params = weights
    cfg = CFG
    if "cfg" in kw:
        cfg = CFG.with_(**kw.pop("cfg"))
        params = init_params(cfg, device="cpu", seed=0)
    calls = [lambda: ServeEngine(cfg, params, **kw)]
    if "planner" in kw:
        session = Session.from_plan(
            CFG, plan(CFG, ShapeConfig("host", 64, 8, "train"), 1),
            device="cpu")
        session.params = params
        eng = session.serve(slots=2, max_len=64, chunk_tokens=16)
        assert isinstance(eng, ServeEngine) and session.mesh is None
        got = _serve_session(eng, _prompts(0, (5, 23)), 3)
        assert got == _serve(params, _prompts(0, (5, 23)), 3)[0]
        calls = [lambda m=m: getattr(session, m)("decode_4k")
                 for m in kw["planner"]]
    for call in calls:
        with pytest.raises(NotImplementedError, match=re.escape(item)):
            call()


def _serve_session(eng, prompts, new):
    for i, p in enumerate(prompts):
        eng.submit(i, p, max_new=new)
    return {i: list(r.out) for i, r in eng.run().items()}


def test_one_pod_mesh_serves_the_streams_without_pod(weights, tmp_path):
    """A ("pod", "data", "model") = (1, 1, 1) mesh over a one-rank gloo
    group: the engine serves its one row, with the streams of the
    ("data", "model") = (1, 1) mesh and of no mesh; a mesh with an axis
    beside those three raises ValueError naming the axes."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    _, _, params = weights
    prompts = _prompts(0, (5, 23))
    want = _serve(params, prompts, 3)[0]
    got = {}
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        for axes in (("pod", "data", "model"), ("data", "model")):
            mesh = make_mesh((1,) * len(axes), axes, device_type="cpu")
            got[axes] = _serve(params, prompts, 3, mesh=mesh)[0]
    finally:
        dist.destroy_process_group()
    assert got[("pod", "data", "model")] == got[("data", "model")] == want
    with pytest.raises(ValueError, match="'pipe'"):
        ServeEngine(CFG, params, mesh={"pipe": 1, "data": 1, "model": 1})


def test_unported_requests_and_families_raise(weights):
    _, _, params = weights
    eng = ServeEngine(CFG, params)
    # frames on a dense engine: the reference's ValueError naming audio
    with pytest.raises(ValueError, match="only meaningful for audio"):
        eng.submit(0, np.ones(3, np.int32), max_new=2,
                   frames=np.zeros((2, 2), np.float32))
    # images on a dense engine: the reference's ValueError naming vlm
    with pytest.raises(ValueError) as got:
        eng.submit(0, np.ones(3, np.int32), max_new=2,
                   images=np.zeros((2, 2), np.float32))
    assert str(got.value) == ("request 0: images are only meaningful for "
                              "vlm archs, not dense")
    # the MoE family serves on the pool (mixed step by default) and
    # prefills unbucketed (tests/test_torch_moe_serve.py
    # holds its streams to the JAX engine's), and so does the enc-dec
    # audio family (tests/test_torch_encdec_serve.py); the VLM on dense
    # rows through the split path, unbucketed
    # (tests/test_torch_vlm_serve.py)
    moe = CFG.with_(arch_type="moe", num_experts=4, experts_per_token=2)
    eng = ServeEngine(moe, init_params(moe, device="cpu", seed=0))
    assert eng.paged and eng.mixed and not eng._bucketed
    audio = CFG.with_(arch_type="audio", num_kv_heads=4, encoder_layers=1,
                      encoder_ctx=8)
    eng = ServeEngine(audio, init_params(audio, device="cpu", seed=0))
    assert eng.paged and eng.mixed and not eng._bucketed
    assert eng._cache["xkv"]["k"].shape == (2, 4, 8, 4, 16)
    vlm = CFG.with_(arch_type="vlm", num_layers=3, cross_attn_every=2,
                    num_image_tokens=8)
    eng = ServeEngine(vlm, init_params(vlm, device="cpu", seed=0))
    assert not eng.paged and not eng.mixed and not eng._bucketed
    assert eng._cache["xkv"]["k"].shape == (1, 4, 8, 2, 16)
    assert eng._cache["kv_g"]["k"].shape == (2, 4, 256, 2, 16)


def test_session_serves_on_cpu_and_keeps_reference_keywords(weights):
    _, _, params = weights
    session = Session(CFG, device="cpu", params=params)
    eng = session.serve(slots=2, max_len=64, chunk_tokens=16, seed=3)
    assert eng.device.type == "cpu"
    for i, p in enumerate(_prompts(0, (5, 23))):
        eng.submit(i, p, max_new=3)
    got = {i: list(r.out) for i, r in eng.run().items()}
    ref, _ = _serve(params, _prompts(0, (5, 23)), 3)
    assert got == ref
    # tp= needs a process group of that many ranks (tests/test_torch_tp.py
    # serves under one); dp= needs as many devices as replicas (the one CPU
    # device repeated serves, tests/test_torch_parallel.py); plan= gives
    # the defaults: a one-chip plan serves the same streams, a tp 2 plan
    # needs the ranks, a pp 2 plan raises unless tp= and dp= are given
    from repro_torch.api import Degrees, Plan
    from repro_torch.configs.base import ShapeConfig
    with pytest.raises(ValueError, match="no process group"):
        session.serve(tp=2)
    with pytest.raises(ValueError, match="devices needed"):
        session.serve(dp=2)
    shape = ShapeConfig("host", 64, 8, "train")
    one = Plan.from_degrees(CFG, shape, Degrees())
    eng = session.serve(plan=one, slots=2, max_len=64, chunk_tokens=16,
                        seed=3)
    assert _serve_session(eng, _prompts(0, (5, 23)), 3) == ref
    with pytest.raises(ValueError, match="no process group"):
        session.serve(plan=Plan.from_degrees(CFG, shape, Degrees(tp=2)))
    pipe = Plan.from_degrees(CFG, shape, Degrees(pp=2))
    with pytest.raises(ValueError, match="pp=2"):
        session.serve(plan=pipe)
    assert isinstance(session.serve(plan=pipe, tp=1, dp=1), ServeEngine)
    with pytest.raises(ValueError, match="attn_backend"):
        session.serve(attn_backend="gather")
    fresh = Session(CFG, device="cpu", seed=7)
    assert fresh.params["embed"].device.type == "cpu"


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve as launcher
    results = launcher.main(["--device", "cpu", "--requests", "3",
                             "--max-new", "3", "--trace-level", "0"])
    assert len(results) == 3 and all(r.done for r in results.values())
    assert "plain path" in capsys.readouterr().out


@pytest.mark.parametrize("flags,layout", [
    (["--no-mixed"], "paged/16tok-pages, split prefill/decode"),
    (["--dense"], "dense slot table, split prefill/decode")])
def test_launcher_serves_the_split_path_on_cpu(capsys, flags, layout):
    """``--no-mixed`` and ``--dense`` reach the split path and give the
    default mixed run's streams (the same seeded requests)."""
    from repro_torch.launch import serve as launcher
    args = ["--device", "cpu", "--requests", "3", "--max-new", "3",
            "--trace-level", "0"]
    mixed = launcher.main(args)
    capsys.readouterr()
    split = launcher.main(args + flags)
    assert layout in capsys.readouterr().out
    assert {i: r.out for i, r in split.items()} == \
        {i: r.out for i, r in mixed.items()}


@pytest.mark.parametrize("flags", [[], ["--no-mixed"]])
def test_launcher_serves_prefix_cache_and_lazy_on_cpu(capsys, flags):
    """``--prefix-cache --lazy --shared-prefix`` on a pool below demand
    serve on both paged paths, print the reference's counter line, and
    give the streams of the run without them."""
    from repro_torch.launch import serve as launcher
    args = ["--device", "cpu", "--slots", "4", "--requests", "4",
            "--max-new", "24", "--trace-level", "0", "--shared-prefix",
            "32"] + flags
    plain = launcher.main(args)
    capsys.readouterr()
    shared = launcher.main(args + ["--prefix-cache", "--lazy",
                                   "--kv-pages", "6"])
    out = capsys.readouterr().out
    hits = re.search(r"prefix hit/miss (\d+)/(\d+) blocks .* (\d+) "
                     r"preemptions, (\d+) CoW copies", out)
    assert hits and int(hits.group(1)) >= 3 * 2 and int(hits.group(3)) >= 1
    assert {i: r.out for i, r in shared.items()} == \
        {i: r.out for i, r in plain.items()}


def test_launcher_serves_speculative_decode_on_cpu(capsys):
    """``--spec-k 2`` (both drafters) serves the default run's streams and
    prints the drafted/accepted line."""
    from repro_torch.launch import serve as launcher
    args = ["--device", "cpu", "--requests", "3", "--max-new", "6",
            "--trace-level", "0"]
    plain = launcher.main(args)
    capsys.readouterr()
    for drafter in ("ngram", "model"):
        spec = launcher.main(args + ["--spec-k", "2", "--drafter", drafter])
        out = capsys.readouterr().out
        assert re.search(rf"spec: k=2 drafter={drafter}, \d+/\d+ drafts "
                         r"accepted", out), out
        assert {i: r.out for i, r in spec.items()} == \
            {i: r.out for i, r in plain.items()}


def test_launcher_serve_mode_over_http_on_cpu(capsys, monkeypatch):
    """``--serve --port 0``: the server comes up, answers /healthz while
    the launcher waits, and closes on ctrl-c."""
    import json
    import urllib.request
    from repro_torch.launch import serve as launcher
    seen = {}

    def sleep(_):
        url = re.search(r"on (http://\S+) ", capsys.readouterr().out)[1]
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            seen["health"] = json.loads(r.read())
        raise KeyboardInterrupt

    monkeypatch.setattr(launcher.time, "sleep", sleep)
    assert launcher.main(["--device", "cpu", "--serve", "--port", "0",
                          "--spec-k", "2", "--watchdog-timeout",
                          "5"]) is None
    assert seen["health"]["status"] == "ok"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {f.relative_to(ROOT / "src").as_posix() for f in files[:-1]}
    assert {"repro_torch/kernels/flash_attention.py",
            "repro_torch/train/step.py", "repro_torch/train/trainer.py",
            "repro_torch/optim/optimizers.py",
            "repro_torch/checkpoint/io.py", "repro_torch/data/pipeline.py",
            "repro_torch/core/strategy.py",
            "repro_torch/launch/train.py",
            "repro_torch/kernels/ssd_scan.py", "repro_torch/models/ssm.py",
            "repro_torch/models/mamba_lm.py",
            "repro_torch/models/hybrid.py", "repro_torch/models/moe.py",
            "repro_torch/models/encdec.py", "repro_torch/models/vlm.py",
            "repro_torch/serve/speculative.py",
            "repro_torch/serve/driver.py", "repro_torch/serve/server.py",
            "repro_torch/serve/metrics.py", "repro_torch/core/pspec.py",
            "repro_torch/core/sharding.py", "repro_torch/core/tp.py",
            "repro_torch/launch/mesh.py",
            "repro_torch/launch/ranks.py",
            "repro_torch/serve/parallel.py",
            "repro_torch/core/opgraph.py", "repro_torch/core/costmodel.py",
            "repro_torch/core/planner.py"} <= names
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; import repro_torch, "
            "repro_torch.api, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.kernels.build, "
            "repro_torch.kernels.flash_attention, repro_torch.core, "
            "repro_torch.optim, repro_torch.checkpoint, "
            "repro_torch.data.pipeline, repro_torch.train.trainer, "
            "repro_torch.kernels.ssd_scan, repro_torch.models.mamba_lm, "
            "repro_torch.models.hybrid, repro_torch.models.moe, "
            "repro_torch.models.encdec, repro_torch.models.vlm, "
            "repro_torch.serve.speculative, repro_torch.serve.driver, "
            "repro_torch.serve.server, repro_torch.serve.metrics, "
            "repro_torch.core.sharding, repro_torch.core.tp, "
            "repro_torch.launch.mesh, repro_torch.launch.ranks, "
            "repro_torch.serve.parallel, repro_torch.core.opgraph, "
            "repro_torch.core.costmodel, repro_torch.core.planner; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "is_available" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
