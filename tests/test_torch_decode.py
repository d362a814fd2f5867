"""The port's dense and ring KV caches, prefill and decode against the JAX
package (repro_torch/models/{kvcache,transformer}.py, serve/step.py).

The JAX side initialises the weights (``jax.random``) and the bridge
carries them over; every other input comes from numpy with a seed.
Tolerances: the cache helpers exactly (they only move values); logits
of the port against the reference's at 1e-4 (fp32, another summation
order); the port's own decode against its teacher-forced ``forward`` at
the reference's ``TOL = 5e-5`` (tests/test_decode_consistency.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.strategy import Strategy as JaxStrategy  # noqa: E402
from repro.models import get_model, kvcache as jkv  # noqa: E402
from repro.serve import step as jstep  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.strategy import Strategy  # noqa: E402
from repro_torch.models import kvcache, transformer  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serve import step  # noqa: E402

TOL = 5e-5            # tests/test_decode_consistency.py
LOGITS_TOL = 1e-4
DENSE = ("qwen3-14b", "deepseek-coder-33b", "internlm2-20b", "minitron-4b")


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(arch, seed=0, **kw):
    """(port cfg, JAX cfg, JAX params, port params on the CPU) of an
    arch's smoke config in float32."""
    jcfg = jax_smoke(arch).with_(dtype="float32", **kw)
    cfg = get_smoke(arch).with_(dtype="float32", **kw)
    jparams = get_model(jcfg).init(jax.random.key(seed), jcfg)
    return cfg, jcfg, jparams, from_numpy(_flatten(jparams), cfg, "cpu")


@pytest.fixture(scope="module")
def qwen():
    return _pair("qwen3-14b")


@pytest.fixture(scope="module")
def qwen_swa():
    return _pair("qwen3-14b", seed=3, sliding_window=16)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(b, s)).astype(np.int32)


# ----------------------------------------------------------- cache helpers

def _kv_pair(seed, b=3, t=8, h=2, d=4):
    """A random (B, T, Hkv, D) cache as numpy, and one new token a row."""
    rng = np.random.default_rng(seed)
    cache = {k: rng.standard_normal((b, t, h, d)).astype(np.float32)
             for k in ("k", "v")}
    new = {k: rng.standard_normal((b, 1, h, d)).astype(np.float32)
           for k in ("k", "v")}
    return cache, new


@pytest.mark.parametrize("pos,ring", [
    (5, False), ([0, 5, 7], False), ([0, 5, 8], False),     # 8: past the end
    (11, True), ([3, 9, 17], True)])
def test_write_kv_matches_reference(pos, ring):
    """Scalar (lockstep) and per-row (slot table) cursors, linear and ring;
    a cursor past a linear cache writes nothing, as the reference's
    scatter drops it."""
    cache, new = _kv_pair(1)
    want = jkv.write_kv({k: jnp.asarray(v) for k, v in cache.items()},
                        jnp.asarray(new["k"]), jnp.asarray(new["v"]),
                        jnp.asarray(pos, jnp.int32), ring=ring, window=8)
    got = {k: _t(v) for k, v in cache.items()}
    out = kvcache.write_kv(got, _t(new["k"]), _t(new["v"]),
                           torch.tensor(pos, dtype=torch.int32), ring=ring,
                           window=8)
    assert out is got                              # in place
    for k in ("k", "v"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_write_kv_vector_positions_equal_a_loop_of_scalar_writes():
    """tests/test_serve_engine.py:335 on the port: the per-row scatter is
    a per-row loop of scalar writes."""
    cache, new = _kv_pair(2)
    pos = torch.tensor([0, 5, 7], dtype=torch.int32)
    got = kvcache.write_kv({k: _t(v) for k, v in cache.items()},
                           _t(new["k"]), _t(new["v"]), pos)
    want = {k: _t(v) for k, v in cache.items()}
    for b in range(3):
        kvcache.write_kv({k: v[b:b + 1] for k, v in want.items()},
                         _t(new["k"])[b:b + 1], _t(new["v"])[b:b + 1],
                         pos[b])
    for k in ("k", "v"):
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("s", [5, 8, 13, 16, 21])
def test_fit_prefill_matches_reference(s):
    """Shorter than the window (front, zero tail), equal, and longer,
    aligned or not (the last w rows rolled so p lands in slot p % w)."""
    k = np.random.default_rng(s).standard_normal((2, s, 2, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(kvcache.fit_prefill(_t(k), 8).numpy(),
                                  np.asarray(jkv.fit_prefill(k, 8)))


def test_ring_slot_kpos_and_copy_page_match_reference():
    for pos in (0, 3, 8, 11, 30):
        np.testing.assert_array_equal(
            kvcache.ring_kpos(torch.tensor(pos), 8).numpy(),
            np.asarray(jkv.ring_kpos(jnp.asarray(pos), 8)))
        assert int(kvcache.ring_slot(torch.tensor(pos), 8)) == \
            int(jkv.ring_slot(pos, 8))
    rows = np.array([[2], [9], [17]], np.int32)
    np.testing.assert_array_equal(
        kvcache.ring_kpos(torch.from_numpy(rows), 8).numpy(),
        np.asarray(jkv.ring_kpos(jnp.asarray(rows), 8)))
    rng = np.random.default_rng(4)
    pool = {k: rng.standard_normal((2, 5, 4, 2, 3)).astype(np.float32)
            for k in ("k", "v")}
    want = jkv.copy_page({k: jnp.asarray(v) for k, v in pool.items()}, 1, 3)
    got = {k: _t(v) for k, v in pool.items()}
    assert kvcache.copy_page(got, 1, 3) is got
    for k in ("k", "v"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    dense = kvcache.init_kv(3, 8, 2, 4, torch.float32)
    ref = jkv.init_kv(3, 8, 2, 4, jnp.float32)
    assert all(tuple(dense[k].shape) == ref[k].shape and
               not dense[k].any() for k in ("k", "v"))


# ------------------------------------------------------ prefill and decode

@pytest.mark.parametrize("window", [0, 16])
def test_init_cache_matches_reference(qwen, window):
    cfg, jcfg = qwen[0].with_(sliding_window=window), \
        qwen[1].with_(sliding_window=window)
    got = transformer.init_cache(cfg, 2, 48)
    want = get_model(jcfg).init_cache(jcfg, 2, 48)
    assert transformer.cache_window(cfg, 48) == \
        get_model(jcfg).cache_window(jcfg, 48)
    for k in ("k", "v"):
        assert tuple(got["kv"][k].shape) == want["kv"][k].shape
        assert got["kv"][k].dtype == torch.float32
    assert got["pos"].shape == () and int(got["pos"]) == 0


@pytest.mark.parametrize("last_pos", [None, 9, [9, 4]])
def test_prefill_matches_reference(qwen, last_pos):
    """A right-padded 16-token bucket: logits gathered at ``last_pos``
    (none: the last row; a scalar; one a row) within 1e-4, and the cache
    filled as the reference fills it."""
    cfg, jcfg, jparams, params = qwen
    toks = _tokens(0, 2, 16, cfg.vocab_size)
    mod = get_model(jcfg)
    want, wcache = mod.prefill(
        jparams, {"tokens": jnp.asarray(toks)}, jcfg,
        mod.init_cache(jcfg, 2, 24),
        last_pos=None if last_pos is None else jnp.asarray(last_pos))
    cache = transformer.init_cache(cfg, 2, 24)
    got, out = transformer.prefill(
        params, {"tokens": _t(toks)}, cfg, cache,
        last_pos=None if last_pos is None else torch.tensor(last_pos))
    assert out is cache and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LOGITS_TOL, rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache["kv"][k].numpy(),
                                   np.asarray(wcache["kv"][k]), atol=1e-5,
                                   rtol=0)
    assert int(cache["pos"]) == int(wcache["pos"]) == 16


@pytest.mark.parametrize("ring,vector", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_decode_step_matches_reference(qwen, qwen_swa, ring, vector):
    """Four decode steps after a 20-token prefill, on the linear cache and
    on the ring (window 16 < 20, unaligned), at one cursor for all rows or
    at per-row cursors: logits within 1e-4 of the reference's."""
    cfg, jcfg, jparams, params = qwen_swa if ring else qwen
    mod = get_model(jcfg)
    toks = _tokens(5, 2, 24, cfg.vocab_size)
    _, jcache = mod.prefill(jparams, {"tokens": jnp.asarray(toks[:, :20])},
                            jcfg, mod.init_cache(jcfg, 2, 40))
    cache = transformer.init_cache(cfg, 2, 40)
    transformer.prefill(params, {"tokens": _t(toks[:, :20])}, cfg, cache)
    for pos in range(20, 24):
        tok = toks[:, pos:pos + 1]
        jpos = jnp.full((2,), pos, jnp.int32) if vector \
            else jnp.asarray(pos, jnp.int32)
        want, jcache = mod.decode_step(jparams, jcache, jnp.asarray(tok),
                                       jpos, jcfg)
        tpos = torch.full((2,), pos, dtype=torch.int32) if vector else pos
        got, cache = transformer.decode_step(params, cache, _t(tok), tpos,
                                             cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_TOL, rtol=0, err_msg=str(pos))
        assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()


def _decode_vs_forward(cfg, params, toks, prompt, steps, max_len):
    """The port's prefill of ``prompt`` tokens and ``steps`` decodes
    against its own teacher-forced forward; returns the worst error."""
    full, _ = transformer.forward(params, {"tokens": toks}, cfg)
    cache = transformer.init_cache(cfg, toks.shape[0], max_len)
    lg, cache = transformer.prefill(params, {"tokens": toks[:, :prompt]},
                                    cfg, cache)
    errs = [(lg[:, 0] - full[:, prompt - 1]).abs().max().item()]
    for pos in range(prompt, prompt + steps):
        lg, cache = transformer.decode_step(params, cache,
                                            toks[:, pos:pos + 1], pos, cfg)
        errs.append((lg[:, 0] - full[:, pos]).abs().max().item())
    return max(errs)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """tests/test_decode_consistency.py::test_decode_matches_forward on
    the port: B 2, S 32, prefill 28, four decodes."""
    cfg, _, _, params = _pair(arch)
    toks = _t(_tokens(0, 2, 32, cfg.vocab_size))
    assert _decode_vs_forward(cfg, params, toks, 28, 4, 32) < TOL


@pytest.mark.parametrize("prompt", [32, 20])
def test_ring_cache_decode_matches_forward(qwen_swa, prompt):
    """tests/test_decode_consistency.py's ring cases on the port: window
    16 < S 48, a prompt of 32 (aligned) or 20 (unaligned: fit_prefill
    must roll the kept rows), eight decodes."""
    cfg, _, _, params = qwen_swa
    assert transformer.init_cache(cfg, 2, 48)["kv"]["k"].shape[2] == 16
    toks = _t(_tokens(3, 2, 48, cfg.vocab_size))
    assert _decode_vs_forward(cfg, params, toks, prompt, 8, 48) < TOL


def test_cp_decode_still_raises_naming_its_item(qwen):
    """``cp_decode=True`` with no rank current raises nothing: it is the
    ordinary decode, as the reference's is where ``cp_available`` is
    False (no mesh). A prefill of 4 and four decode steps on whole rows
    (no ``"kv_slice"``) give the reference's ``decode_step`` logits with
    ``cp_decode`` on within LOGITS_TOL. Under a rank the CP branch runs
    (tests/test_torch_tp.py, tests/test_torch_parallel.py)."""
    cfg, jcfg, jparams, params = qwen
    cfg, jcfg = cfg.with_(cp_decode=True), jcfg.with_(cp_decode=True)
    toks = _tokens(8, 2, 8, cfg.vocab_size)
    mod = get_model(jcfg)
    _, jcache = mod.prefill(jparams, {"tokens": jnp.asarray(toks[:, :4])},
                            jcfg, mod.init_cache(jcfg, 2, 16))
    cache = transformer.init_cache(cfg, 2, 16)
    assert "kv_slice" not in cache and cache["kv"]["k"].shape[2:4] == (16, 2)
    transformer.prefill(params, {"tokens": _t(toks[:, :4])}, cfg, cache)
    for pos in range(4, 8):
        want, jcache = mod.decode_step(jparams, jcache,
                                       jnp.asarray(toks[:, pos:pos + 1]),
                                       jnp.asarray(pos, jnp.int32), jcfg)
        got, cache = transformer.decode_step(
            params, cache, _t(toks[:, pos:pos + 1]), pos, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGITS_TOL, rtol=0)


# ------------------------------------------------------------- serve steps

def test_prefill_and_decode_steps_match_reference_with_microbatches(qwen):
    """``make_prefill_step`` with two microbatches gives the one-batch
    logits and cache, and both the reference's; ``make_decode_step``
    continues from it as ``decode_step`` does."""
    cfg, jcfg, jparams, params = qwen
    toks = _tokens(9, 4, 12, cfg.vocab_size)
    want, _ = jstep.make_prefill_step(jcfg, JaxStrategy())(
        jparams, {"tokens": jnp.asarray(toks)})
    one = step.make_prefill_step(cfg, Strategy(dtype="float32"))
    two = step.make_prefill_step(cfg, Strategy(dtype="float32",
                                               microbatches=2))
    lg1, c1 = one(params, {"tokens": _t(toks)})
    lg2, c2 = two(params, {"tokens": _t(toks)})
    np.testing.assert_allclose(lg1.numpy(), np.asarray(want),
                               atol=LOGITS_TOL, rtol=0)
    assert torch.equal(lg1, lg2)
    for k in ("k", "v"):
        assert torch.equal(c1["kv"][k], c2["kv"][k])
    decode = step.make_decode_step(cfg, Strategy(dtype="float32"))
    tok = _t(toks[:, -1:])
    got, _ = decode(params, c2, tok, 11)
    ref, _ = transformer.decode_step(params, c1, tok, 11, cfg)
    assert torch.equal(got, ref)


def test_scatter_prefill_pages_matches_reference():
    rng = np.random.default_rng(6)
    pool = {k: rng.standard_normal((2, 6, 4, 2, 3)).astype(np.float32)
            for k in ("k", "v")}
    kvs = {k: rng.standard_normal((2, 1, 12, 2, 3)).astype(np.float32)
           for k in ("k", "v")}
    pages = np.array([4, 2, 0], np.int32)
    want = jstep.scatter_prefill_pages(
        {k: jnp.asarray(v) for k, v in pool.items()},
        {k: jnp.asarray(v) for k, v in kvs.items()}, jnp.asarray(pages), 4)
    got = {k: _t(v) for k, v in pool.items()}
    step.scatter_prefill_pages(got, {k: _t(v) for k, v in kvs.items()},
                               torch.from_numpy(pages), 4)
    for k in ("k", "v"):             # the null page 0 takes pads: skip it
        np.testing.assert_array_equal(got[k].numpy()[:, 1:],
                                      np.asarray(want[k])[:, 1:])
