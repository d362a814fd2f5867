"""The port's engine serving the MoE family against the JAX engine: the
mixed step, the split path on the pool and on the dense layout, the
prefix cache with its whole-context salt, lazy growth and speculative
decode (repro_torch/serve/engine.py over models/moe.py).

Capacity routing couples the rows of one program, so the port is held to
the JAX engine run by run: the same config, seed, prompts and keywords
give the same greedy streams and the same counters. Each JAX engine run
is made once (``_jax_run``) and shared; each port run beside it also
shows the equality the reference's own test asserts (single slot against
sequential decode, mixed against split, dense against paged, spec on
against spec off). The config is the reference tests' ``MOE_CFG``
(2 layers, d 64, 4 experts top 2, float32) at capacity factor 1.25, or
2.0 where the reference asks for no-drop routing.
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

KW = dict(name="engine-moe", arch_type="moe", num_layers=2, d_model=64,
          num_heads=4, num_kv_heads=2, d_ff=128, num_experts=4,
          experts_per_token=2, vocab_size=128, dtype="float32")

COUNTERS = ("prefills", "decode_tokens", "prefill_chunk_tokens",
            "decode_steps", "decode_slot_steps", "peak_pages",
            "decode_traces", "prefill_traces", "prefix_hit_blocks",
            "prefix_miss_blocks", "prefix_tail_hits", "prefix_evictions",
            "prefix_decode_blocks", "preemptions", "cow_copies",
            "spec_drafted", "spec_accepted")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes are tiny: one intra-op thread computes them as fast,
    and the test workers running beside this one keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=(int(n),)).astype(np.int32)
            for n in lens]


def _random_lens(seed, n=5):
    """tests/test_serve_engine.py:162's prompts: each length drawn just
    before its tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=(int(rng.integers(3, 10)),))
            .astype(np.int32) for _ in range(n)]


def _repeats():
    """tests/test_serve_prefix.py:81's prompts: p, p, q, p."""
    rng = np.random.default_rng(6)
    p = rng.integers(0, 128, size=(11,)).astype(np.int32)
    q = rng.integers(0, 128, size=(9,)).astype(np.int32)
    return [p, p, q, p]


def _spec_prompts():
    """tests/test_serve_spec.py:172's prompts: two random, two tiled
    motifs."""
    rng = np.random.default_rng(5)
    out = [rng.integers(0, 128, size=(n,)).astype(np.int32) for n in (5, 19)]
    for _ in range(2):
        motif = rng.integers(0, 128, size=(int(rng.integers(3, 6)),))
        out.append(np.tile(motif, int(rng.integers(4, 7))).astype(np.int32))
    return out


#: run -> (capacity factor, prompts, max_new, engine keywords; ``spec``
#: the draft length k): the reference tests' settings (file:line of each
#: in its docstring's test)
RUNS = {
    "single": (1.25, _prompts(5, (5, 8)), 5, dict(slots=1, max_len=32)),
    "batched": (1.25, _random_lens(6), 4, dict(slots=3, max_len=32)),
    "mixed": (2.0, _prompts(5, (5, 19, 8, 27)), 5,
              dict(slots=2, max_len=64, paged=True, mixed=True,
                   chunk_tokens=16)),
    "paged1": (1.25, _random_lens(6), 4,
               dict(slots=1, max_len=32, paged=True, page_size=8)),
    "paged3": (1.25, _random_lens(6), 4,
               dict(slots=3, max_len=32, paged=True, page_size=8)),
    "prefix": (1.25, _repeats(), 4,
               dict(slots=1, max_len=32, paged=True, page_size=4,
                    prefix_cache=True, lazy=True)),
    "spec": (2.0, _spec_prompts(), 6,
             dict(slots=2, max_len=64, paged=True, mixed=True,
                  chunk_tokens=16, spec=4)),
}

_JAX_PARAMS = []
_JAX_RUNS = {}


def _jax_params():
    """The reference's init of MOE_CFG at seed 5, jitted once (the
    capacity factor shapes no weight)."""
    if not _JAX_PARAMS:
        jcfg = JaxConfig(**KW)
        _JAX_PARAMS.append(jax.jit(jax_model(jcfg).init, static_argnums=1)(
            jax.random.key(5), jcfg))
    return _JAX_PARAMS[0]


def _port_params():
    return from_numpy(_flatten(_jax_params()), ModelConfig(**KW), "cpu")


def _engine_kw(kw, spec_cls):
    if kw.get("spec"):
        kw = dict(kw, spec=spec_cls(k=kw["spec"]))
    return kw


def _jax_run(name):
    """(streams, stats, engine) of the JAX engine on run ``name``, made
    once."""
    if name not in _JAX_RUNS:
        cf, prompts, new, kw = RUNS[name]
        eng = JaxEngine(JaxConfig(**KW, moe_capacity_factor=cf),
                        _jax_params(), **_engine_kw(kw, JaxSpec))
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=new)
        res = eng.run()
        _JAX_RUNS[name] = ({i: list(res[i].out) for i in res},
                           dict(eng.stats), eng)
    return _JAX_RUNS[name]


def _port_run(name, params, **over):
    """(streams, engine) of the port's engine on run ``name``, with
    keywords ``over`` replacing the run's."""
    cf, prompts, new, kw = RUNS[name]
    cfg = ModelConfig(**KW, moe_capacity_factor=cf)
    eng = ServeEngine(cfg, params, **_engine_kw({**kw, **over}, SpecConfig))
    for i, p in enumerate(prompts):
        eng.submit(i, p, max_new=new)
    res = eng.run()
    assert all(r.done for r in res.values())
    return {i: list(res[i].out) for i in res}, eng


def _same_counters(eng, jstats):
    for key in COUNTERS:
        assert eng.stats[key] == jstats[key], key


@pytest.fixture(scope="module")
def params():
    return _port_params()


def test_single_slot_matches_jax_engine_and_sequential(params):
    """tests/test_serve_engine.py:143: one slot on the default mixed step
    — the JAX engine's streams and counters, each request equal to
    ``Session.generate`` of it alone (one row: capacity sees what
    sequential decode sees)."""
    want, jstats, _ = _jax_run("single")
    got, eng = _port_run("single", params)
    assert eng.paged and eng.mixed
    assert got == want
    _same_counters(eng, jstats)
    session = Session(ModelConfig(**KW), device="cpu", params=params)
    for i, p in enumerate(RUNS["single"][1]):
        assert session.generate(p, steps=5)[0].tolist() == got[i], i


def test_batched_serves_all_as_the_jax_engine(params):
    """tests/test_serve_engine.py:162: a full 3-slot table (rows share
    expert capacity) — every request done with in-vocab tokens, one
    decode shape, and the JAX engine's streams and counters."""
    want, jstats, _ = _jax_run("batched")
    got, eng = _port_run("batched", params)
    assert got == want
    assert set(got) == set(range(5))
    assert all(0 <= t < 128 for out in got.values() for t in out)
    assert eng.stats["decode_traces"] == 1
    _same_counters(eng, jstats)


def test_mixed_matches_split_and_jax_no_drop(params):
    """tests/test_serve_mixed.py:99: no-drop capacity (cf 2.0) makes
    dispatch row-independent, so the port's mixed step (chunk 16), its
    split path on the pool and the JAX engine's mixed step give the same
    streams; the split path prefills each prompt at its exact length
    (no bucket: 4 prefill shapes for 4 lengths)."""
    want, jstats, _ = _jax_run("mixed")
    mixed, me = _port_run("mixed", params)
    split, se = _port_run("mixed", params, mixed=False)
    assert mixed == split == want
    _same_counters(me, jstats)
    assert me.stats["prefill_traces"] == 0
    assert not se.mixed and se.paged
    assert se.stats["prefill_traces"] == 4
    assert se.stats["decode_traces"] == 1


def test_paged_matches_dense_and_jax(params):
    """tests/test_serve_paged.py:72: one slot, 8-token pages — the dense
    layout's split path and the pool's mixed step give the JAX engine's
    streams; three slots on the pool serve every request with the JAX
    engine's streams and counters."""
    want, jstats, _ = _jax_run("paged1")
    paged, pe = _port_run("paged1", params)
    dense, de = _port_run("paged1", params, paged=False)
    assert not de.paged and pe.paged
    assert dense == paged == want
    _same_counters(pe, jstats)
    assert pe.stats["decode_traces"] == 1
    want3, jstats3, _ = _jax_run("paged3")
    batched, be = _port_run("paged3", params)
    assert batched == want3
    assert all(0 <= t < 128 for out in batched.values() for t in out)
    _same_counters(be, jstats3)
    assert be.stats["decode_traces"] == 1


def test_prefix_cache_shares_identical_contexts_as_jax(params):
    """tests/test_serve_prefix.py:81: the prefix cache keys an MoE block
    on the whole context, so repeats of p share its two full 4-token
    blocks and q matches nothing — the JAX engine's streams and every
    counter (``prefix_hit_blocks`` included), each request equal to its
    sequential decode; the salt equals the JAX engine's."""
    want, jstats, jeng = _jax_run("prefix")
    got, eng = _port_run("prefix", params)
    assert got == want
    _same_counters(eng, jstats)
    assert eng.stats["prefix_hit_blocks"] >= 4
    assert eng.stats["decode_traces"] == 1
    cfg = ModelConfig(**KW)
    for i, p in enumerate(RUNS["prefix"][1]):
        alone = greedy_generate(params, cfg, None,
                                {"tokens": torch.from_numpy(p[None])}, 4)
        assert alone[0].tolist() == got[i], i
    req, jreq = eng.finished[1], jeng.finished[1]
    ctx = np.concatenate([req.prompt, np.asarray(req.out, np.int32)])
    salt = eng._salt(req, ctx)
    assert salt == jeng._salt(jreq, ctx)
    assert salt[0] == "moe-ctx" and req.salt_cache[0] == len(ctx)
    assert eng._salt(req, ctx[:-1]) != salt           # a new length, anew


def test_spec_matches_plain_and_jax(params):
    """tests/test_serve_spec.py:172: no-drop capacity, the ngram drafter
    at k 4 — spec-on streams equal spec-off's and the JAX engine's, and
    the drafted and accepted counts equal the JAX engine's."""
    want, jstats, _ = _jax_run("spec")
    spec, se = _port_run("spec", params)
    plain, _ = _port_run("spec", params, spec=None)
    assert spec == plain == want
    _same_counters(se, jstats)
    assert se.stats["spec_drafted"] > 0


def test_moe_kernel_checks_on_a_cuda_device(params):
    """On a CUDA device (no card needed to refuse) an MoE engine checks
    paged attention on the pool and flash on the split path, and never
    the fused MLP: an MoE layer runs none."""
    bad_heads = ModelConfig(**dict(KW, dtype="bfloat16", head_dim=20))
    with pytest.raises(ValueError, match="paged-attention kernel"):
        ServeEngine(bad_heads, params, device="cuda")
    with pytest.raises(ValueError, match="flash-attention kernel"):
        ServeEngine(bad_heads, params, paged=False, device="cuda")
    for arch, refused in (("moe", False), ("dense", True)):
        cfg = ModelConfig(**dict(KW, arch_type=arch, dtype="bfloat16",
                                 d_ff=20,
                                 num_experts=4 if arch == "moe" else 0))
        for mixed in (True, False):
            eng = SimpleNamespace(cfg=cfg, paged=True, mixed=mixed,
                                  page_size=16, spec=None, device="cuda")
            if refused:
                with pytest.raises(ValueError, match="fused-MLP kernel"):
                    ServeEngine._check_kernel_limits(eng)
            else:
                ServeEngine._check_kernel_limits(eng)


@pytest.mark.parametrize("arch,flags", [
    ("olmoe-1b-7b", []), ("olmoe-1b-7b", ["--no-mixed"]),
    ("olmoe-1b-7b", ["--dense"]), ("kimi-k2-1t-a32b", [])])
def test_serve_launcher_runs_moe_on_cpu(arch, flags, capsys):
    """``launch/serve.py --arch`` on the MoE smoke configs in float32: the
    mixed step by default, the split path on the pool and on the dense
    layout; every request done with its tokens."""
    from repro_torch.launch import serve as launcher
    results = launcher.main(["--arch", arch, "--device", "cpu",
                             "--requests", "3", "--max-new", "4", *flags])
    assert len(results) == 3
    assert all(r.done and len(r.out) == 4 for r in results.values())
    text = capsys.readouterr().out
    assert "plain path" in text
    assert ("split prefill/decode" in text) == bool(flags)
