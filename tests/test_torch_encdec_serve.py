"""The port's engine serving the enc-dec audio family against the JAX
engine: the mixed step with its separate encode program, the split path
on the pool and on the dense layout, frames validation, the prefix cache
with its frames salt and speculative decode
(repro_torch/serve/engine.py over models/encdec.py).

Each run is held to the JAX engine's on the same config, seed, prompts
and frames: the same greedy streams and the same counters
(``encode_traces``, ``decode_traces``, ``prefill_traces``, prefix hits,
spec counts). Each JAX engine run is made once (``_jax_run``) and shared;
each port run beside it also shows the equality the reference's own test
asserts (mixed against split, paged against dense and sequential decode,
spec on against spec off). The config is the reference tests'
``AUDIO_CFG`` (2 decoder layers, 1 encoder layer of 12 frames, d 64,
4/4 heads, float32) at seed 2.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.speculative import SpecConfig as JaxSpec  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.speculative import SpecConfig  # noqa: E402
from repro_torch.serve.step import greedy_generate  # noqa: E402

KW = dict(name="engine-encdec", arch_type="audio", num_layers=2,
          d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
          encoder_layers=1, encoder_ctx=12, dtype="float32")

COUNTERS = ("prefills", "decode_tokens", "prefill_chunk_tokens",
            "decode_steps", "decode_slot_steps", "peak_pages",
            "decode_traces", "prefill_traces", "encode_traces",
            "prefix_hit_blocks", "prefix_miss_blocks", "prefix_tail_hits",
            "prefix_evictions", "prefix_decode_blocks", "preemptions",
            "cow_copies", "spec_drafted", "spec_accepted")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes are tiny: one intra-op thread computes them as fast,
    and the test workers running beside this one keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(rng, n):
    return [rng.standard_normal((12, 64)).astype(np.float32)
            for _ in range(n)]


def _traffic(lens):
    """The reference tests' draw: prompts of ``lens`` tokens, then one
    frame block each, from ``default_rng(2)``."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, size=(int(n),)).astype(np.int32)
               for n in lens]
    return prompts, _frames(rng, len(prompts))


def _prefix_traffic():
    """tests/test_serve_prefix.py:104's traffic: an 8-token system prompt
    with two suffixes under the same frames, then the first prompt again
    under other frames."""
    rng = np.random.default_rng(2)
    system = rng.integers(0, 128, size=(8,)).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 128, size=(n,))
                               .astype(np.int32)]) for n in (3, 4)]
    prompts.append(prompts[0].copy())
    f1, f2 = _frames(rng, 2)
    return prompts, [f1, f1, f2]


def _spec_traffic():
    """tests/test_serve_spec.py:183's traffic: two random prompts and two
    tiled motifs, then one frame block each."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, size=(n,)).astype(np.int32)
               for n in (4, 9)]
    for _ in range(2):
        motif = rng.integers(0, 128, size=(int(rng.integers(3, 6)),))
        prompts.append(np.tile(motif, int(rng.integers(4, 7)))
                       .astype(np.int32))
    return prompts, _frames(rng, len(prompts))


#: run -> (traffic, max_new, engine keywords; ``spec`` the draft length
#: k): the reference tests' settings (file:line in each test's docstring)
RUNS = {
    "mixed": (_traffic((4, 17, 5, 11)), 5,
              dict(slots=2, max_len=32, paged=True, mixed=True,
                   chunk_tokens=16)),
    "paged": (_traffic((4, 7, 5)), 5,
              dict(slots=2, max_len=32, paged=True, page_size=8)),
    "prefix": (_prefix_traffic(), 5,
               dict(slots=2, max_len=32, paged=True, page_size=4,
                    prefix_cache=True, lazy=True)),
    "spec": (_spec_traffic(), 5,
             dict(slots=2, max_len=48, paged=True, mixed=True,
                  chunk_tokens=16, spec=4)),
}

_JAX_PARAMS = []
_JAX_RUNS = {}


def _jax_params():
    """The reference's init of AUDIO_CFG at seed 2, jitted once."""
    if not _JAX_PARAMS:
        jcfg = JaxConfig(**KW)
        _JAX_PARAMS.append(jax.jit(jax_model(jcfg).init, static_argnums=1)(
            jax.random.key(2), jcfg))
    return _JAX_PARAMS[0]


def _engine_kw(kw, spec_cls):
    if kw.get("spec"):
        kw = dict(kw, spec=spec_cls(k=kw["spec"]))
    return kw


def _jax_run(name):
    """(streams, stats, engine) of the JAX engine on run ``name``, made
    once."""
    if name not in _JAX_RUNS:
        (prompts, frames), new, kw = RUNS[name]
        eng = JaxEngine(JaxConfig(**KW), _jax_params(),
                        **_engine_kw(kw, JaxSpec))
        for i, (p, f) in enumerate(zip(prompts, frames)):
            eng.submit(i, p, max_new=new, frames=f)
        res = eng.run()
        _JAX_RUNS[name] = ({i: list(res[i].out) for i in res},
                           dict(eng.stats), eng)
    return _JAX_RUNS[name]


def _port_run(name, params, **over):
    """(streams, engine) of the port's engine on run ``name``, with
    keywords ``over`` replacing the run's."""
    (prompts, frames), new, kw = RUNS[name]
    eng = ServeEngine(ModelConfig(**KW), params,
                      **_engine_kw({**kw, **over}, SpecConfig))
    for i, (p, f) in enumerate(zip(prompts, frames)):
        eng.submit(i, p, max_new=new, frames=f)
    res = eng.run()
    assert all(r.done for r in res.values())
    return {i: list(res[i].out) for i in res}, eng


def _same_counters(eng, jstats):
    for key in COUNTERS:
        assert eng.stats[key] == jstats[key], key


@pytest.fixture(scope="module")
def params():
    return from_numpy(_flatten(_jax_params()), ModelConfig(**KW), "cpu")


def _sequential(params, name, new):
    """Each request of run ``name`` alone through the lockstep greedy
    loop (``greedy_generate`` on a batch dict with frames)."""
    (prompts, frames), _, _ = RUNS[name]
    out = {}
    for i, (p, f) in enumerate(zip(prompts, frames)):
        toks = greedy_generate(params, ModelConfig(**KW), None,
                               {"tokens": torch.from_numpy(p[None]),
                                "frames": torch.from_numpy(f[None])}, new)
        out[i] = toks[0].tolist()
    return out


def test_mixed_matches_split_and_jax(params):
    """tests/test_serve_mixed.py:109: the encoder runs once an admission
    as its own program (one encode shape), the cross K/V lands in the
    slot's block, and the chunked decoder prefill (chunk 16) gives the
    split path's streams — both equal to the JAX engine's, with its
    counters; the split path on the pool prefills each prompt at its
    exact length and runs no encode program."""
    want, jstats, _ = _jax_run("mixed")
    mixed, me = _port_run("mixed", params)
    split, se = _port_run("mixed", params, mixed=False)
    assert mixed == split == want
    _same_counters(me, jstats)
    assert me.stats["encode_traces"] == 1
    assert me.stats["prefill_traces"] == 0
    assert not se.mixed and se.paged and not se._bucketed
    assert se.stats["prefill_traces"] == 4
    assert se.stats["encode_traces"] == 0
    assert se.stats["decode_traces"] == 1


def test_paged_matches_dense_sequential_and_jax(params):
    """tests/test_serve_paged.py:100: per-request frames ride through
    prefill, the decoder K/V pages and the cross K/V stays a block a slot
    — the pool's mixed step, the dense layout's split path and sequential
    greedy decode give the JAX engine's streams, one decode shape each,
    and the pool's counters equal the JAX engine's; the resident state
    counts the cross K/V blocks."""
    want, jstats, jeng = _jax_run("paged")
    paged, pe = _port_run("paged", params)
    dense, de = _port_run("paged", params, paged=False)
    assert pe.paged and pe.mixed and not de.paged
    assert paged == dense == want == _sequential(params, "paged", 5)
    _same_counters(pe, jstats)
    assert pe.stats["decode_traces"] == de.stats["decode_traces"] == 1
    assert pe.kv_bytes() == jeng.kv_bytes()
    xkv = 2 * 2 * 2 * 12 * 4 * 16 * 4       # k, v x L x slots x ctx x H x D
    assert pe.kv_bytes() - xkv == sum(
        t.numel() * 4 for t in pe._cache["kv"].values())


def test_frames_validation_matches_the_reference(params):
    """tests/test_serve_paged.py:209: an audio request without frames, or
    with frames of another shape, raises the reference's ``ValueError``
    with its text; frames on a dense engine raise naming ``audio``; the
    stored frames are float32; ``images=`` on an audio engine raises the
    reference's ``ValueError`` naming ``vlm``."""
    jeng = JaxEngine(JaxConfig(**KW), _jax_params(), slots=1, max_len=32)
    eng = ServeEngine(ModelConfig(**KW), params, slots=1, max_len=32)
    prompt = np.arange(4, dtype=np.int32)
    for kw, match in ((dict(), "frames"),
                      (dict(frames=np.zeros((3, 3), np.float32)), "shape")):
        with pytest.raises(ValueError, match=match) as want:
            jeng.submit(0, prompt, max_new=2, **kw)
        with pytest.raises(ValueError, match=match) as got:
            eng.submit(0, prompt, max_new=2, **kw)
        assert str(got.value) == str(want.value)
    dense = ModelConfig(name="paged-dense", arch_type="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                        vocab_size=128, dtype="float32")
    from repro_torch.params import init_params
    dense_eng = ServeEngine(dense, init_params(dense, device="cpu"), slots=1,
                            max_len=32)
    with pytest.raises(ValueError, match="audio"):
        dense_eng.submit(0, prompt, max_new=2,
                         frames=np.zeros((12, 64), np.float32))
    req = eng.submit(1, prompt, max_new=2,
                     frames=np.zeros((12, 64), np.float64))
    assert req.frames.dtype == np.float32
    kw = dict(frames=np.zeros((12, 64), np.float32),
              images=np.zeros((4, 64), np.float32))
    with pytest.raises(ValueError, match="vlm") as want:
        jeng.submit(2, prompt, max_new=2, **kw)
    with pytest.raises(ValueError, match="vlm") as got:
        eng.submit(2, prompt, max_new=2, **kw)
    assert str(got.value) == str(want.value)


def test_prefix_cache_salts_blocks_with_the_frames_as_jax(params):
    """tests/test_serve_prefix.py:104: the prefix cache keys an enc-dec
    block on a digest of the frames, so request 1 shares request 0's two
    system blocks (same frames) and request 2 — request 0's tokens under
    other frames — shares nothing: exactly 2 hit blocks, every stream
    equal to sequential decode and to the JAX engine's, every counter
    equal; the salt equals the JAX engine's."""
    want, jstats, jeng = _jax_run("prefix")
    got, eng = _port_run("prefix", params)
    assert got == want == _sequential(params, "prefix", 5)
    _same_counters(eng, jstats)
    assert eng.stats["prefix_hit_blocks"] == 2
    assert eng.stats["decode_traces"] == 1
    salts = []
    for rid in range(3):
        req, jreq = eng.finished[rid], jeng.finished[rid]
        salt = eng._salt(req, req.prompt)
        assert salt == jeng._salt(jreq, jreq.prompt)
        assert salt[0] == "frames" and req.salt_cache == (0, salt)
        salts.append(salt)
    assert salts[0] == salts[1] != salts[2]


def test_spec_matches_plain_and_jax(params):
    """tests/test_serve_spec.py:183: the ngram drafter at k 4 on the mixed
    step — spec-on streams equal spec-off's and the JAX engine's, and the
    drafted and accepted counts (every counter) equal the JAX engine's."""
    want, jstats, _ = _jax_run("spec")
    spec, se = _port_run("spec", params)
    plain, _ = _port_run("spec", params, spec=None)
    assert spec == plain == want
    _same_counters(se, jstats)
    assert se.stats["spec_drafted"] > 0


def test_preempted_request_reencodes_and_resumes(params):
    """A preempted audio request re-runs its encoder at readmission (the
    reference's ``_admit_mixed``) and resumes by re-prefill: the streams
    equal an uninterrupted run's; ``encode_traces`` stays 1 and survives
    ``reset_stats``."""
    want, _ = _port_run("mixed", params)
    (prompts, frames), new, kw = RUNS["mixed"]
    eng = ServeEngine(ModelConfig(**KW), params, **kw)
    for i, (p, f) in enumerate(zip(prompts, frames)):
        eng.submit(i, p, max_new=new, frames=f)
    while not any(r is not None and len(r.out) >= 2 for r in eng.active):
        eng.step()
    slot = next(s for s, r in enumerate(eng.active)
                if r is not None and len(r.out) >= 2)
    eng.preempt(slot)
    eng.reset_stats()
    res = eng.run()
    assert {i: list(res[i].out) for i in res} == want
    assert eng.stats["preemptions"] == 0 and eng.stats["encode_traces"] == 1


def test_session_serves_audio_and_generates_with_frames(params):
    """``Session.serve`` builds the audio engine on the pool (mixed by
    default); ``Session.generate`` takes a batch dict with frames and
    gives sequential decode's stream; ``serve_async(start=False)``
    forwards each request's frames."""
    session = Session(ModelConfig(**KW), device="cpu", params=params)
    want, _, _ = _jax_run("paged")
    (prompts, frames), new, _ = RUNS["paged"]
    got = session.generate({"tokens": prompts[0][None],
                            "frames": frames[0][None]}, steps=new)
    assert got[0].tolist() == want[0]
    eng = session.serve(slots=2, max_len=32, page_size=8)
    assert eng.paged and eng.mixed and "xkv" in eng._cache
    driver = session.serve_async(slots=2, max_len=32, page_size=8,
                                 start=False)
    streams = [driver.submit(p, max_new=new, rid=i, frames=f)
               for i, (p, f) in enumerate(zip(prompts, frames))]
    driver.start()
    out = {s.rid: s.tokens() for s in streams}
    driver.stop(drain=True, timeout=60)
    assert out == want


def test_audio_kernel_checks_on_a_cuda_device(params):
    """On a CUDA device (no card needed to refuse) an audio engine checks
    paged attention on the pool and flash for its encoder on every path,
    and never the fused MLP (its MLP is plain GeLU)."""
    bad_heads = ModelConfig(**dict(KW, dtype="bfloat16", head_dim=20))
    with pytest.raises(ValueError, match="paged-attention kernel"):
        ServeEngine(bad_heads, params, device="cuda")
    for mixed in (True, False):
        eng = SimpleNamespace(cfg=bad_heads, paged=False, mixed=mixed,
                              page_size=16, spec=None, device="cuda")
        with pytest.raises(ValueError, match="flash-attention kernel"):
            ServeEngine._check_kernel_limits(eng)
    odd_ff = ModelConfig(**dict(KW, dtype="bfloat16", d_ff=20))
    for mixed in (True, False):
        eng = SimpleNamespace(cfg=odd_ff, paged=True, mixed=mixed,
                              page_size=16, spec=None, device="cuda")
        ServeEngine._check_kernel_limits(eng)


@pytest.mark.parametrize("flags", [[], ["--no-mixed"], ["--dense"]])
def test_serve_launcher_runs_whisper_on_cpu(flags, capsys):
    """``launch/serve.py --arch whisper-tiny`` on its smoke config in
    float32, each request with seeded frames: the mixed step by default,
    the split path on the pool and on the dense layout; every request done
    with its tokens."""
    from repro_torch.launch import serve as launcher
    results = launcher.main(["--arch", "whisper-tiny", "--device", "cpu",
                             "--requests", "3", "--max-new", "4", *flags])
    assert len(results) == 3
    assert all(r.done and len(r.out) == 4 and r.frames is not None
               for r in results.values())
    text = capsys.readouterr().out
    assert "plain path" in text
    assert ("split prefill/decode" in text) == bool(flags)
