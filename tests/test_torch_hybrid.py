"""The port's hybrid family (Mamba2 backbone + one shared attention block,
zamba2-1.2b) against the JAX package: its weight bridge, forward, prefill
and decode (repro_torch/{params,models/hybrid}), its serving path
(serve/engine.py, api/session.py, launch/serve.py) and the engines'
refusals on a CUDA device (no card needed to refuse).

The same numpy inputs (from a seed) go through ``repro.models.hybrid`` and
the port on weights the reference initialised and the bridge carried
over. Configs: ``zamba2-smoke`` (2 layers, every 2: one group and
``rest == 0``), a ``rest > 0`` variant (3 layers: one trailing Mamba
layer) and a sliding-window variant (window 16: the ring wraps), all in
float32. Tolerances: logits at 1e-5 (fp32, another summation order),
the states and K/V of the decode chain at 1e-5, token streams identical.
Each engine run keeps to 3 prompt lengths: the JAX engine compiles one
prefill for each exact length.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten, save_checkpoint  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.strategy import Strategy as JaxStrategy  # noqa: E402
from repro.models import hybrid as jhy  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.step import greedy_generate as jax_generate  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import get_model, hybrid  # noqa: E402
from repro_torch.params import (from_numpy, init_params, load_npz,  # noqa: E402
                                param_spec)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.step import greedy_generate  # noqa: E402

#: the three hybrid configs: name -> overrides of zamba2-smoke (float32)
CONFIGS = {"rest0": {},
           "rest1": dict(num_layers=3, hybrid_attn_every=2),
           "swa16": dict(sliding_window=16)}


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


def _cfgs(name, dtype="float32"):
    kw = dict(CONFIGS[name], dtype=dtype)
    return (jax_smoke("zamba2-1.2b").with_(**kw),
            get_smoke("zamba2-1.2b").with_(**kw))


_INITS = {}


def _init(seed, jcfg):
    """``repro.models.hybrid.init`` under ``jax.jit`` (one compile a
    config, not one a primitive), made once a (seed, config). The window
    shapes no weight, so a sliding-window config takes the weights of the
    same config without it."""
    jcfg = jcfg.with_(sliding_window=0)
    if (seed, jcfg) not in _INITS:
        _INITS[seed, jcfg] = jax.jit(jhy.init, static_argnums=1)(
            jax.random.key(seed), jcfg)
    return _INITS[seed, jcfg]


_PAIRS = {}


def _pair(name, seed=1):
    """(JAX cfg, port cfg, JAX params, port params) on the same weights,
    made once a config."""
    if name not in _PAIRS:
        jcfg, cfg = _cfgs(name)
        jparams = _init(seed, jcfg)
        _PAIRS[name] = (jcfg, cfg, jparams,
                        from_numpy(_flatten(jparams), cfg, "cpu"))
    return _PAIRS[name]


def _prompts(seed, lens, vocab=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(int(n),)).astype(np.int32)
            for n in lens]


# ---------------------------------------------------------------- params

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_bridge_round_trip_is_total_and_exact(dtype):
    """A JAX hybrid.init tree through from_numpy: every leaf (the unused
    trailing layer at rest == 0 included), exact; bf16 bitwise."""
    jcfg, cfg = _cfgs("rest0", dtype)
    jparams = _init(1 if dtype == "float32" else 0, jcfg)
    flat = _flatten(jparams)
    port = _flat_port(from_numpy(flat, cfg, "cpu"))
    assert set(port) == set(flat) == set(param_spec(cfg))
    assert port["trailing/mamba/in_proj"].shape[0] == 1
    assert port["groups/mamba/in_proj"].shape[:2] == (1, 2)
    for key, arr in flat.items():
        assert str(port[key].dtype) == f"torch.{arr.dtype.name}", key
        np.testing.assert_array_equal(port[key].float().numpy(),
                                      np.asarray(arr, np.float32),
                                      err_msg=key)
    if dtype == "bfloat16":
        for key in ("groups/mamba/in_proj", "shared/attn/wq",
                    "trailing/mamba/out_proj"):
            np.testing.assert_array_equal(
                port[key].view(torch.int16).numpy(),
                np.asarray(flat[key]).view(np.int16), err_msg=key)


def test_load_npz_reads_a_jax_hybrid_checkpoint(tmp_path):
    jcfg, cfg = _cfgs("rest0", "bfloat16")
    jparams = _init(0, jcfg)
    step_dir = save_checkpoint(tmp_path, 1, jparams)
    loaded = _flat_port(load_npz(step_dir, cfg, "cpu"))
    for key, t in _flat_port(from_numpy(_flatten(jparams), cfg,
                                        "cpu")).items():
        assert torch.equal(loaded[key], t), key


def test_init_params_matches_reference_shapes_dtypes_and_scales():
    """zamba2-smoke in bf16: shapes and dtypes equal the JAX tree's, the
    deterministic leaves equal it (dt_bias and A_log within an ulp of
    XLA's linspace, over the (G, every) stacking), the random ones have
    its std within 5%."""
    jcfg, cfg = jax_smoke("zamba2-1.2b"), get_smoke("zamba2-1.2b")
    flat = _flatten(_init(0, jcfg))
    mine = _flat_port(init_params(cfg, device="cpu", seed=0))
    assert set(mine) == set(flat)
    for key, arr in flat.items():
        t, a = mine[key], np.asarray(arr, np.float32)
        assert tuple(t.shape) == arr.shape, key
        assert str(t.dtype) == f"torch.{arr.dtype.name}", key
        _, _, init = param_spec(cfg)[key]
        if isinstance(init, str):
            np.testing.assert_allclose(t.float().numpy(), a, rtol=1e-6,
                                       atol=0, err_msg=key)
        else:
            assert abs(t.float().std().item() / a.std() - 1) < 0.05, key


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_logits_match_jax(name):
    """64 tokens (two SSD chunks of 32): logits within 1e-5, remat on and
    off (remat changes no value)."""
    jcfg, cfg, jparams, params = _pair(name)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    want, _ = jax.jit(lambda p_, t: jhy.forward(p_, {"tokens": t}, jcfg))(
        jparams, jnp.asarray(tokens))
    assert get_model(cfg) is hybrid
    for remat in (False, True):
        got, aux = hybrid.forward(params, {"tokens": _t(tokens)}, cfg,
                                  remat=remat)
        assert float(aux) == 0.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def _jax_rows(jcfg, jparams, prompts, max_len):
    """The reference's prefill of each prompt alone, stitched into row r
    of a batched cache (as its engine does), and the last logits."""
    big = jhy.init_cache(jcfg, len(prompts), max_len)
    prefill = jax.jit(jhy.prefill, static_argnums=2)
    logits = []
    for r, p in enumerate(prompts):
        lg, c1 = prefill(jparams, {"tokens": jnp.asarray(p)[None]}, jcfg,
                         jhy.init_cache(jcfg, 1, max_len))
        big = {k: v if k == "pos" else jax.tree.map(
            lambda b, o: b.at[:, r].set(o[:, 0]), v, c1[k])
            for k, v in big.items()}
        logits.append(lg[0])
    return jnp.stack(logits), big


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_then_decode_chain_matches_jax(name):
    """Two prompts (32 and 20 tokens) prefilled alone into rows of one
    batched cache of 64 positions (the port writes row views in place),
    then 8 decode steps at per-row cursors 32 + i and 20 + i: logits,
    states and K/V within 1e-5 at every step."""
    jcfg, cfg, jparams, params = _pair(name)
    prompts = _prompts(3, (32, 20))
    jlog, jcache = _jax_rows(jcfg, jparams, prompts, 64)
    cache = hybrid.init_cache(cfg, 2, 64)
    logs = []
    for r, p in enumerate(prompts):
        row = {k: {n: a[:, r:r + 1] for n, a in v.items()}
               for k, v in cache.items() if isinstance(v, dict)}
        lg, _ = hybrid.prefill(params, {"tokens": _t(p)[None]}, cfg, row)
        logs.append(lg[0])
    np.testing.assert_allclose(torch.stack(logs).numpy(), np.asarray(jlog),
                               atol=1e-5, rtol=1e-5)
    pos = np.array([32, 20], np.int32)
    jstep = jax.jit(lambda p_, c, t, i: jhy.decode_step(p_, c, t, i, jcfg))
    for _ in range(8):
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tok),
                             jnp.asarray(pos))
        state = cache["ssm_g"]["state"]
        log, cache = hybrid.decode_step(params, cache, _t(tok), _t(pos), cfg)
        assert cache["ssm_g"]["state"] is state          # in place
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-5,
                                   rtol=1e-5)
        for key in ("ssm_g", "ssm_t", "kv"):
            for leaf, arr in cache[key].items():
                np.testing.assert_allclose(
                    arr.numpy(), np.asarray(jcache[key][leaf]), atol=1e-5,
                    rtol=1e-5, err_msg=f"{key}/{leaf}")
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        pos = pos + 1


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_matches_jax_engine_and_greedy_generate(name):
    """2 slots, prompts of 5, 23 and 9 tokens, 8 new each: the port's
    streams equal the JAX engine's and each request's greedy_generate
    (the port's, and the reference's for the first request on rest0);
    trace counts and the state's bytes equal the JAX engine's."""
    jcfg, cfg, jparams, params = _pair(name)
    prompts = _prompts(0, (5, 23, 9))
    jeng = JaxEngine(jcfg, jparams, slots=2, max_len=48)
    eng = ServeEngine(cfg, params, slots=2, max_len=48)
    assert not eng.paged and not eng.mixed
    for e in (jeng, eng):
        for i, p in enumerate(prompts):
            e.submit(i, p, max_new=8)
    jres, res = jeng.run(), eng.run()
    for i, p in enumerate(prompts):
        seq = greedy_generate(params, cfg, None, {"tokens": _t(p)[None, :]},
                              steps=8)
        want = [int(t) for t in seq[0]]
        assert res[i].done and res[i].out == jres[i].out == want, i
    if name == "rest0":
        seq = jax_generate(jparams, jcfg, JaxStrategy(),
                           {"tokens": jnp.asarray(prompts[0])[None, :]},
                           steps=8)
        assert res[0].out == [int(t) for t in np.asarray(seq)[0]]
    for key in ("decode_traces", "prefill_traces", "prefills",
                "decode_steps", "decode_tokens"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["decode_traces"] == 1
    assert eng.stats["prefill_traces"] == 3
    assert eng.kv_bytes() == jeng.kv_bytes()


def test_session_generate_matches_reference():
    """``Session.generate`` on a (2, 12) prompt, 6 steps: the reference's
    lockstep loop's tokens."""
    jcfg, cfg, jparams, params = _pair("rest1")
    prompt = np.stack(_prompts(5, (12, 12)))
    got = Session(cfg, device="cpu", params=params).generate(prompt, steps=6)
    want = jax_generate(jparams, jcfg, JaxStrategy(),
                        {"tokens": jnp.asarray(prompt)}, steps=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_max_new_one_and_eos_finish_at_prefill():
    """As for the reference's engine: max_new 1 and EOS on the prefill
    token finish at admission with no decode step."""
    jcfg, cfg, jparams, params = _pair("rest0")
    prompt = _prompts(1, (7,))[0]
    outs = []
    for engine, p_ in ((JaxEngine, jparams), (ServeEngine, params)):
        c = jcfg if engine is JaxEngine else cfg
        eng = engine(c, p_, slots=1, max_len=32)
        eng.submit(0, prompt, max_new=1)
        res = eng.run()
        assert res[0].done and len(res[0].out) == 1
        assert eng.stats["decode_steps"] == 0 and eng.active == [None]
        outs.append(res[0].out)
    assert outs[0] == outs[1]
    eos = ServeEngine(cfg, params, slots=1, max_len=32, eos_id=outs[1][0])
    eos.submit(0, prompt, max_new=8)
    assert eos.run()[0].out == outs[1]
    assert eos.stats["decode_steps"] == 0


def test_engine_refuses_a_prompt_past_the_chunk_precondition():
    """A 40-token prompt at ssm_chunk 32 (40 % 32 != 0): both engines fail
    inside the request's prefill, after it left the queue; 64 tokens (two
    chunks) are served."""
    jcfg, cfg, jparams, params = _pair("rest0")
    prompt = _prompts(6, (40,))[0]
    jeng = JaxEngine(jcfg, jparams, slots=2, max_len=80)
    jeng.submit(0, prompt, max_new=2)
    with pytest.raises(AssertionError):
        jeng.step()
    eng = ServeEngine(cfg, params, slots=2, max_len=80)
    eng.submit(0, prompt, max_new=2)
    with pytest.raises(ValueError, match=re.escape("s % min(chunk, s)")):
        eng.step()
    assert len(jeng.queue) == len(eng.queue) == 0
    ok = ServeEngine(cfg, params, slots=2, max_len=80)
    ok.submit(0, _prompts(7, (64,))[0], max_new=3)
    assert all(r.done and len(r.out) == 3 for r in ok.run().values())


@pytest.mark.parametrize("kw", [{"paged": True}, {"prefix_cache": True},
                                {"lazy": True}, {"mixed": True}])
def test_engine_layout_rules_refuse_like_the_reference(kw):
    """The hybrid is not pageable: both engines raise ValueError, with the
    reference's message but for the pageable families it lists (the port
    lists those it has ported)."""
    jcfg, cfg, jparams, params = _pair("rest0")
    with pytest.raises(ValueError) as jexc:
        JaxEngine(jcfg, jparams, slots=2, max_len=64, **kw)
    with pytest.raises(ValueError) as exc:
        ServeEngine(cfg, params, slots=2, max_len=64, **kw)

    def families_out(msg):
        return re.sub(r"\([a-z/]+, no sliding window\)", "(...)", msg)

    assert families_out(str(exc.value)) == families_out(str(jexc.value))


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_engine_on_cuda_refuses_ssd_limits_at_construction(arch):
    """An SSM or hybrid engine built for a CUDA device refuses, at
    construction (no card needed), a config whose Mamba heads the SSD
    kernel cannot take (ssm_head_dim 96 > 64), naming the limit, and
    launches nothing; on the CPU the plain version takes it."""
    from repro_torch.kernels import ssd_scan as sk
    cfg = get_smoke(arch).with_(ssm_head_dim=96)
    params = init_params(cfg, device="cpu", seed=0)
    kernels.reset_launches()
    with pytest.raises(ValueError, match=r"SSD-scan kernel.*1\.\.64 channels"):
        ServeEngine(cfg, params, slots=2, max_len=64, device="cuda")
    assert sum(kernels.launches().values()) == 0
    assert "channels" in sk.kernel_limits(cfg.dtype, 4, 96, 16, 32)
    assert sk.kernel_limits(cfg.dtype, 4, 64, 16, 32) is None
    ServeEngine(cfg, params, slots=2, max_len=64)            # the CPU


def test_hybrid_engine_on_cuda_refuses_flash_and_mlp_limits():
    """On a CUDA device the hybrid engine also checks the kernels of its
    shared block: flash attention (every prefill; bf16 head dim 20) and
    the fused MLP (every program; bf16 d_ff 100)."""
    cfg = get_smoke("zamba2-1.2b")                      # bfloat16
    params = init_params(cfg, device="cpu", seed=0)
    kernels.reset_launches()
    for kw, match in ((dict(head_dim=20), "flash-attention kernel"),
                      (dict(d_ff=100), "fused-MLP kernel")):
        with pytest.raises(ValueError, match=match):
            ServeEngine(cfg.with_(**kw), params, device="cuda")
    assert sum(kernels.launches().values()) == 0


def test_launcher_serves_the_hybrid_on_cpu(capsys):
    from repro_torch.launch import serve as launcher
    results = launcher.main(["--arch", "zamba2-1.2b", "--device", "cpu",
                             "--requests", "3", "--max-new", "3",
                             "--trace-level", "0"])
    assert len(results) == 3 and all(r.done and len(r.out) == 3
                                     for r in results.values())
    out = capsys.readouterr().out
    assert "split prefill/decode" in out and "plain path" in out
