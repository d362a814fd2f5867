"""The port's params, layers and dense decoder against the JAX package
(repro_torch/{params,models}).

The JAX side initialises (``jax.random``) and the weight bridge carries
the tree over, so both frameworks compute on identical weights; the
other inputs come from numpy with a seed. Tolerances: layers at 1e-5
(fp32, another summation order), logits at 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten, save_checkpoint  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import get_model, kvcache as jkv  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import kvcache, layers, transformer  # noqa: E402
from repro_torch.params import (from_numpy, init_params, load_npz,  # noqa: E402
                                param_spec)

CFG_KW = dict(name="pal-dense", arch_type="dense", num_layers=2, d_model=128,
              num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=128,
              dtype="float32")


def _pair(kw, seed=0):
    """(port cfg, JAX cfg, JAX params, port params on the CPU)."""
    jcfg = JaxConfig(**kw)
    jparams = get_model(jcfg).init(jax.random.key(seed), jcfg)
    cfg = ModelConfig(**kw)
    return cfg, jcfg, jparams, from_numpy(_flatten(jparams), cfg, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat_port(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_port(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# -------------------------------------------------------------- params

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_bridge_round_trip_is_total_and_exact(dtype):
    kw = dict(CFG_KW, qk_norm=True, dtype=dtype)
    cfg, _, jparams, tparams = _pair(kw)
    flat = _flatten(jparams)
    port = _flat_port(tparams)
    assert set(port) == set(flat) == set(param_spec(cfg))
    for key, arr in flat.items():
        assert str(port[key].dtype) == f"torch.{arr.dtype.name}", key
        np.testing.assert_array_equal(port[key].float().numpy(),
                                      np.asarray(arr, np.float32), err_msg=key)


def test_load_npz_reads_a_jax_checkpoint(tmp_path):
    kw = dict(CFG_KW, dtype="bfloat16", qk_norm=True)
    cfg, _, jparams, tparams = _pair(kw, seed=1)
    step_dir = save_checkpoint(tmp_path, 3, jparams)
    loaded = _flat_port(load_npz(step_dir, cfg, "cpu"))
    for key, t in _flat_port(tparams).items():
        assert torch.equal(loaded[key], t), key


def test_weight_bridge_rejects_partial_or_misshapen_trees():
    cfg, _, jparams, _ = _pair(CFG_KW)
    flat = _flatten(jparams)
    with pytest.raises(KeyError, match="missing"):
        from_numpy({k: v for k, v in flat.items() if k != "lm_head"}, cfg,
                   "cpu")
    with pytest.raises(KeyError, match="unexpected"):
        from_numpy({**flat, "layers/extra": flat["lm_head"]}, cfg, "cpu")
    bad = dict(flat)
    bad["layers/attn/wq"] = bad["layers/attn/wq"][:, :, :-1]
    with pytest.raises(ValueError, match="shape"):
        from_numpy(bad, cfg, "cpu")
    wrong = dict(flat)
    wrong["embed"] = wrong["embed"].astype(np.float64)
    with pytest.raises(TypeError, match="expected"):
        from_numpy(wrong, cfg, "cpu")


def test_init_params_matches_reference_shapes_dtypes_and_scales():
    kw = dict(CFG_KW, qk_norm=True, dtype="bfloat16")
    cfg, _, jparams, _ = _pair(kw)
    flat = _flatten(jparams)
    mine = _flat_port(init_params(cfg, device="cpu", seed=0))
    assert set(mine) == set(flat)
    for key, arr in flat.items():
        t = mine[key]
        assert tuple(t.shape) == arr.shape, key
        assert str(t.dtype) == f"torch.{arr.dtype.name}", key
        ref_std = float(np.asarray(arr, np.float32).std())
        if ref_std == 0.0:            # norm scales: ones in both
            assert torch.equal(t, torch.ones_like(t)), key
        else:
            assert abs(t.float().std().item() / ref_std - 1) < 0.05, key
    again = _flat_port(init_params(cfg, device="cpu", seed=0))
    assert all(torch.equal(again[k], mine[k]) for k in mine)


# -------------------------------------------------------------- layers

def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    scale = rng.standard_normal((32,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm(_t(x), _t(scale), 1e-5).numpy(),
        np.asarray(jl.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5)),
        atol=1e-5, rtol=1e-5)
    pos = rng.integers(0, 900, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        layers.apply_rope(_t(x), _t(pos), 1e6).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["causal", "per_row", "kpos_window"])
def test_attention_full_matches_reference(case):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 4, 8, 16)).astype(np.float32)
    k = rng.standard_normal((3, 12, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 12, 2, 16)).astype(np.float32)
    kw = {"causal": True}
    if case == "per_row":
        kw.update(q_offset=np.array([0, 3, 8], np.int32),
                  kv_len=np.array([4, 7, 12], np.int32))
    elif case == "kpos_window":
        kw.update(q_offset=np.array([5, 9, 2], np.int32), window=6,
                  kpos=rng.integers(-2, 12, size=(3, 12)).astype(np.int32))
    got = layers.attention_full(
        _t(q), _t(k), _t(v),
        **{n: (_t(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()})
    want = jl.attention_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_attn_qkv_with_qk_norm_matches_reference():
    kw = dict(CFG_KW, qk_norm=True, rope_theta=1e6)
    cfg, jcfg, jparams, tparams = _pair(kw, seed=2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    pos = rng.integers(0, 50, size=(2, 6)).astype(np.int32)
    jattn = jax.tree.map(lambda a: a[1], jparams["layers"]["attn"])
    want = jl.attn_qkv(jattn, jnp.asarray(x), jcfg,
                       positions=jnp.asarray(pos))
    got = layers.attn_qkv(transformer.layer_params(tparams, 1)["attn"],
                          _t(x), cfg, positions=_t(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


# --------------------------------------------------------------- model

@pytest.mark.parametrize("which", ["pal-dense", "qwen3-smoke"])
def test_forward_logits_match_reference(which):
    if which == "pal-dense":
        kw = CFG_KW
    else:
        assert get_smoke("qwen3-14b") == ModelConfig(
            **jax_smoke("qwen3-14b").__dict__)
        kw = dict(jax_smoke("qwen3-14b").with_(dtype="float32").__dict__)
    cfg, jcfg, jparams, tparams = _pair(kw, seed=3)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    want, _ = get_model(jcfg).forward(jparams, {"tokens": jnp.asarray(tokens)},
                                      jcfg)
    got, aux = transformer.forward(tparams, {"tokens": _t(tokens)}, cfg)
    assert got.shape == (2, 11, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_paged_decode_step_with_wtab_matches_reference():
    """One mixed-step program: decode rows, a prefill chunk and a pad row
    whose write is redirected to the null page through ``wtab`` while
    attention reads through ``ptab`` — same pool, same tables, same
    logits and pool contents as the JAX decode_step."""
    kw = dict(CFG_KW, qk_norm=True)
    cfg, jcfg, jparams, tparams = _pair(kw, seed=4)
    rng = np.random.default_rng(4)
    L, n_pages, ps = cfg.num_layers, 9, 4
    pool_k = rng.standard_normal((L, n_pages, ps, 2, 32)).astype(np.float32)
    pool_v = rng.standard_normal((L, n_pages, ps, 2, 32)).astype(np.float32)
    ptab = np.array([[3, 5, 0], [3, 5, 0], [7, 2, 8], [7, 2, 8], [0, 0, 0]],
                    np.int32)
    pos = np.array([6, 5, 9, 10, 0], np.int32)
    wnull = np.array([False, False, False, False, True])
    wtab = np.where(wnull[:, None], 0, ptab).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, size=(5, 1)).astype(np.int32)
    jcache = {"kv": {"k": jnp.asarray(pool_k), "v": jnp.asarray(pool_v)},
              "ptab": jnp.asarray(ptab), "wtab": jnp.asarray(wtab)}
    want, jout = get_model(jcfg).decode_step(jparams, jcache,
                                             jnp.asarray(tokens),
                                             jnp.asarray(pos), jcfg)
    tcache = {"kv": {"k": _t(pool_k), "v": _t(pool_v)}, "ptab": _t(ptab),
              "wtab": _t(wtab)}
    got, tout = transformer.decode_step(tparams, tcache, _t(tokens),
                                        _t(pos), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    # the pool was written in place, exactly where the reference scattered
    # (page 0 takes the pad row's write in both)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tout["kv"][leaf].numpy(),
                                   np.asarray(jout["kv"][leaf]), atol=1e-5,
                                   rtol=1e-5)
    assert tout["kv"]["k"] is tcache["kv"]["k"]


def test_kvcache_helpers_match_reference():
    rng = np.random.default_rng(5)
    pool = rng.standard_normal((6, 4, 2, 8)).astype(np.float32)
    tab = np.array([[2, 4], [5, 1], [0, 0]], np.int32)
    np.testing.assert_array_equal(
        kvcache.gather_pages(_t(pool), _t(tab)).numpy(),
        np.asarray(jkv.gather_pages(jnp.asarray(pool), jnp.asarray(tab))))
    new = rng.standard_normal((3, 1, 2, 8)).astype(np.float32)
    pos = np.array([5, 2, 9], np.int32)    # row 2 past the table: clipped
    want = jkv.write_kv_paged({"k": jnp.asarray(pool), "v": jnp.asarray(pool)},
                              jnp.asarray(new), jnp.asarray(new),
                              jnp.asarray(tab), jnp.asarray(pos))
    cache = {"k": _t(pool), "v": _t(pool)}
    kvcache.write_kv_paged(cache, _t(new), _t(new), _t(tab), _t(pos))
    np.testing.assert_array_equal(cache["k"].numpy(), np.asarray(want["k"]))
    pool0 = kvcache.init_paged_kv(2, 5, 4, 2, 8, torch.float32, "cpu")
    assert pool0["k"].shape == (2, 5, 4, 2, 8) and not pool0["v"].any()
