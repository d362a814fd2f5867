"""The port's SSM family against the JAX package: the SSD scan, the Mamba2
block, the pure-SSM LM, its weight bridge and its serving path
(repro_torch/{kernels/ssd_scan,models/ssm,models/mamba_lm,params,
serve/engine}).

On the CPU the SSD wrapper takes its plain version — the contract the CUDA
kernel is held to on the card (chip_smoke.py phase 3 and the ``gpu``
cases of tests/test_torch_gpu.py). The same numpy inputs (from a seed) go
through the JAX function and the port's; the JAX SSD kernel runs as its
own tests run it, the Pallas body in interpret mode through
``repro.kernels.ops``. Tolerances: the SSD scan at 1e-4, the reference's
(tests/test_kernels.py:118); the block's functions at 1e-5 (fp32, another
summation order); logits at 1e-4; token streams identical.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten, save_checkpoint  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.core.strategy import Strategy as JaxStrategy  # noqa: E402
from repro.kernels import ops, ref  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.models import mamba_lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.step import greedy_generate  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402
from repro_torch.models import get_model, mamba_lm, ssm  # noqa: E402
from repro_torch.params import (from_numpy, init_params, load_npz,  # noqa: E402
                                param_spec)
from repro_torch.serve.engine import ServeEngine  # noqa: E402

# tests/test_serve_engine.py:26
SSM_KW = dict(name="engine-ssm", arch_type="ssm", num_layers=2, d_model=64,
              num_heads=0, num_kv_heads=0, d_ff=128, ssm_state=16,
              ssm_heads=4, ssm_head_dim=16, vocab_size=128, dtype="float32")
SSM_CFG = ModelConfig(**SSM_KW)


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


def _pair(jcfg, cfg, seed=0):
    """JAX-initialised params and their bridge into the port (CPU)."""
    jparams = jax_get_model(jcfg).init(jax.random.key(seed), jcfg)
    return jparams, from_numpy(_flatten(jparams), cfg, "cpu")


@pytest.fixture(scope="module")
def smoke():
    """mamba2-smoke in fp32 (2 layers, d 128, 4 heads x 64, N 16, chunk
    32) in both packages, on the same weights."""
    jcfg = jax_smoke("mamba2-780m").with_(dtype="float32")
    cfg = get_smoke("mamba2-780m").with_(dtype="float32")
    jparams, params = _pair(jcfg, cfg, seed=1)
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def engine_weights():
    jcfg = JaxConfig(**SSM_KW)
    jparams, params = _pair(jcfg, SSM_CFG, seed=4)
    return jcfg, jparams, params


def _ssd_inputs(seed, b, s, h, p, n):
    """tests/test_kernels.py's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((h,)))).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return x, dt, A, B, C


# ---------------------------------------------------------------- SSD scan

@pytest.mark.parametrize("s,h,p,n,chunk", [(128, 2, 32, 16, 32),
                                           (256, 3, 64, 32, 64),
                                           (256, 1, 32, 64, 128)])
def test_ssd_scan_plain_matches_jax_kernel(s, h, p, n, chunk):
    """tests/test_kernels.py:104's shapes: the plain version against the
    Pallas kernel (interpret mode) and the sequential oracle."""
    arrs = _ssd_inputs(s + h, 2, s, h, p, n)
    want = np.asarray(ops.ssd_scan(*map(jnp.asarray, arrs), chunk=chunk))
    y, h_last = sk.ssd_scan(*map(_t, arrs), chunk=chunk)
    assert y.dtype == torch.float32 and h_last.shape == (2, h, p, n)
    np.testing.assert_allclose(y.numpy(), want, atol=1e-4, rtol=1e-4)
    oracle = np.asarray(ref.ssd_scan_ref(*map(jnp.asarray, arrs)))
    np.testing.assert_allclose(y.numpy(), oracle, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s,chunk", [(128, 32), (77, 128), (96, 32)])
def test_ssd_scan_plain_matches_jax_ssd_chunked_y_and_state(s, chunk):
    """y and the final state against ``ssm.ssd_chunked``, a ragged single
    chunk (q = 77) included."""
    arrs = _ssd_inputs(s, 1, s, 2, 32, 16)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, arrs), chunk=chunk)
    y, h_last = sk.ssd_scan_plain(*map(_t, arrs), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)


def test_ssd_scan_ref_matches_jax_ref():
    arrs = _ssd_inputs(9, 2, 40, 3, 8, 4)
    want = np.asarray(ref.ssd_scan_ref(*map(jnp.asarray, arrs)))
    got = tref.ssd_scan_ref(*map(_t, arrs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_chunk_invariance(chunk):
    """tests/test_kernels.py:137: the chunked result does not depend on
    the chunk size; the final state equals the oracle's too."""
    arrs = _ssd_inputs(chunk, 1, 64, 2, 16, 8)
    y, h_last = sk.ssd_scan_plain(*map(_t, arrs), chunk=chunk)
    want = tref.ssd_scan_ref(*map(_t, arrs))
    np.testing.assert_allclose(y.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    _, h64 = sk.ssd_scan_plain(*map(_t, arrs), chunk=64)
    np.testing.assert_allclose(h_last.numpy(), h64.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_ssd_precondition_refused_by_both_packages():
    """``s % min(chunk, s) == 0`` (ssm.py:89, ssd_scan.py:70): the
    reference asserts, the port raises ValueError."""
    arrs = _ssd_inputs(2, 1, 200, 2, 8, 4)
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(*map(jnp.asarray, arrs), chunk=128)
    with pytest.raises(ValueError, match=re.escape("s % min(chunk, s)")):
        ssm.ssd_chunked(*map(_t, arrs), chunk=128)
    with pytest.raises(ValueError, match="s=200, chunk=128"):
        sk.ssd_scan_plain(*map(_t, arrs), chunk=128)


def test_ssd_wrapper_on_cpu_and_cuda_entry_refusals():
    """A CPU tensor takes the plain version and launches nothing; the
    CUDA entry raises when a gradient is required (no backward) and
    takes CUDA tensors only — before any build or launch."""
    arrs = [_t(a) for a in _ssd_inputs(3, 1, 32, 2, 8, 4)]
    before = sk.ssd_scan.launches
    y, _ = sk.ssd_scan(*arrs, chunk=16)
    assert sk.ssd_scan.launches == before
    assert torch.equal(y, sk.ssd_scan_plain(*arrs, chunk=16)[0])
    with pytest.raises(ValueError, match="CUDA"):
        sk.ssd_scan_cuda(*arrs, chunk=16)
    leaf = arrs[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        sk.ssd_scan_cuda(leaf, *arrs[1:], chunk=16)


def test_ssd_chunked_gradients_flow_through_the_plain_path():
    """With a gradient required ``ssd_chunked`` is the differentiable plain
    version (the reference trains through plain jnp): every input gets a
    finite, non-zero gradient, and it equals autograd through the
    sequential oracle."""
    arrs = [_t(a).requires_grad_(True)
            for a in _ssd_inputs(5, 1, 64, 2, 8, 4)]
    y, h_last = ssm.ssd_chunked(*arrs, chunk=16)
    grads = torch.autograd.grad((y ** 2).sum() + h_last.sum(), arrs)
    for g in grads:
        assert torch.isfinite(g).all() and g.abs().sum() > 0
    want = torch.autograd.grad((tref.ssd_scan_ref(*arrs) ** 2).sum(),
                               arrs[0])[0]
    got = torch.autograd.grad((ssm.ssd_chunked(*arrs, chunk=16)[0] ** 2)
                              .sum(), arrs[0])[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_build_key_covers_the_ssd_source(monkeypatch):
    a = build._target("ssd_scan")
    assert a.name.startswith("ssd_scan-") and "ssd_scan" in build.SIGNATURES
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build._target("ssd_scan") != a


# ------------------------------------------------------------ Mamba2 block

def _layer(params, i=0):
    return {k: v[i] for k, v in params["layers"]["mamba"].items()}


def _jlayer(jparams, i=0):
    return {k: v[i] for k, v in jparams["layers"]["mamba"].items()}


def test_split_in_and_causal_conv_match_jax(smoke):
    jcfg, cfg, jparams, params = smoke
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    jz, jxbc, jdt = jssm._split_in(_jlayer(jparams), jnp.asarray(x), jcfg)
    z, xbc, dt = ssm._split_in(_layer(params), _t(x), cfg)
    for got, want in ((z, jz), (xbc, jxbc), (dt, jdt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    lp, jlp = _layer(params), _jlayer(jparams)
    tail0 = rng.standard_normal((2, cfg.ssm_conv_width - 1,
                                 ssm.conv_channels(cfg))).astype(np.float32)
    for init in (None, tail0):
        jy, jtail = jssm._causal_conv(
            jxbc, jlp["conv_w"], jlp["conv_b"],
            init_state=None if init is None else jnp.asarray(init))
        y, tail = ssm._causal_conv(
            xbc, lp["conv_w"], lp["conv_b"],
            init_state=None if init is None else _t(init))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(tail.numpy(), np.asarray(jtail),
                                   atol=1e-5, rtol=1e-5)


def test_mamba_forward_and_step_match_jax(smoke):
    jcfg, cfg, jparams, params = smoke
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 64, cfg.d_model)) * 0.5).astype(np.float32)
    jout, jst = jssm.mamba_forward(_jlayer(jparams), jnp.asarray(x), jcfg,
                                   return_state=True)
    out, st = ssm.mamba_forward(_layer(params), _t(x), cfg,
                                return_state=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    for k in ("state", "conv"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   atol=1e-5, rtol=1e-5)
    x_t = (rng.standard_normal((2, 1, cfg.d_model)) * 0.5).astype(np.float32)
    jo, jnew = jssm.mamba_step(_jlayer(jparams), jst, jnp.asarray(x_t), jcfg)
    o, new = ssm.mamba_step(_layer(params), st, _t(x_t), cfg)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5,
                               rtol=1e-5)
    for k in ("state", "conv"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                   atol=1e-5, rtol=1e-5)


def test_softplus_is_jax_softplus_without_threshold():
    x = np.array([-40.0, -3.0, 0.0, 0.5, 19.0, 21.0, 60.0], np.float32)
    np.testing.assert_allclose(ssm.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-7, atol=0)


# -------------------------------------------------------------- mamba_lm

def test_forward_logits_match_jax(smoke):
    jcfg, cfg, jparams, params = smoke
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    jlog, _ = jlm.forward(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)
    log, aux = mamba_lm.forward(params, {"tokens": _t(tokens)}, cfg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)


def test_prefill_then_decode_chain_matches_jax(smoke):
    """prefill a 64-token prompt (two chunks), then four decode steps at
    per-row cursors, each step's logits and states against the JAX chain
    (the port writes the states in place)."""
    jcfg, cfg, jparams, params = smoke
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    jlog, jcache = jlm.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                               jcfg, jlm.init_cache(jcfg, 2, 80))
    log, cache = mamba_lm.prefill(params, {"tokens": _t(tokens)}, cfg,
                                  mamba_lm.init_cache(cfg, 2, 80))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=1e-4)
    assert int(cache["pos"]) == int(jcache["pos"]) == 64
    pos = np.array([64, 64], np.int32)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
        jlog, jcache = jlm.decode_step(jparams, jcache, jnp.asarray(tok),
                                       jnp.asarray(pos), jcfg)
        state = cache["ssm"]["state"]
        log, cache = mamba_lm.decode_step(params, cache, _t(tok), _t(pos),
                                          cfg)
        assert cache["ssm"]["state"] is state          # in place
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4,
                                   rtol=1e-4)
        for k in ("state", "conv"):
            np.testing.assert_allclose(cache["ssm"][k].numpy(),
                                       np.asarray(jcache["ssm"][k]),
                                       atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        pos = pos + 1


def test_get_model_maps_the_ported_families():
    """dense, SSM, the hybrid, MoE, enc-dec audio and the VLM map to their
    modules (MoE to the decoder's, as in the reference)."""
    from repro_torch.models import encdec, hybrid, transformer, vlm
    assert get_model(SSM_CFG) is mamba_lm
    assert get_model(SSM_CFG.with_(arch_type="dense", num_heads=4,
                                   num_kv_heads=2)) is transformer
    assert get_model(get_smoke("zamba2-1.2b")) is hybrid
    assert get_model(get_smoke("olmoe-1b-7b")) is transformer
    assert get_model(get_smoke("kimi-k2-1t-a32b")) is transformer
    assert get_model(get_smoke("whisper-tiny")) is encdec
    assert get_model(SSM_CFG.with_(arch_type="audio")) is encdec
    assert get_model(get_smoke("llama-3.2-vision-90b")) is vlm
    assert get_model(SSM_CFG.with_(arch_type="vlm")) is vlm


# ---------------------------------------------------------------- params

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_bridge_round_trip_is_total_and_exact(dtype):
    """A JAX mamba_lm.init tree through from_numpy: every leaf, exact;
    bf16 bitwise; and through a checkpoint on disk."""
    kw = dict(SSM_KW, dtype=dtype)
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jparams, params = _pair(jcfg, cfg)
    flat = _flatten(jparams)
    port = _flat_port(params)
    assert set(port) == set(flat) == set(param_spec(cfg))
    for key, arr in flat.items():
        assert str(port[key].dtype) == f"torch.{arr.dtype.name}", key
        np.testing.assert_array_equal(port[key].float().numpy(),
                                      np.asarray(arr, np.float32),
                                      err_msg=key)
    if dtype == "bfloat16":
        bits = port["layers/mamba/in_proj"].view(torch.int16).numpy()
        np.testing.assert_array_equal(
            bits, np.asarray(flat["layers/mamba/in_proj"]).view(np.int16))


def test_load_npz_reads_a_jax_ssm_checkpoint(tmp_path):
    kw = dict(SSM_KW, dtype="bfloat16")
    jcfg, cfg = JaxConfig(**kw), ModelConfig(**kw)
    jparams, params = _pair(jcfg, cfg, seed=2)
    step_dir = save_checkpoint(tmp_path, 1, jparams)
    loaded = _flat_port(load_npz(step_dir, cfg, "cpu"))
    for key, t in _flat_port(params).items():
        assert torch.equal(loaded[key], t), key


def test_weight_bridge_rejects_a_misshapen_ssm_tree():
    jcfg = JaxConfig(**SSM_KW)
    jparams, _ = _pair(jcfg, SSM_CFG)
    flat = _flatten(jparams)
    with pytest.raises(KeyError, match="missing"):
        from_numpy({k: v for k, v in flat.items()
                    if k != "layers/mamba/A_log"}, SSM_CFG, "cpu")
    bad = dict(flat)
    bad["layers/mamba/in_proj"] = bad["layers/mamba/in_proj"][:, :, :-1]
    with pytest.raises(ValueError, match="shape"):
        from_numpy(bad, SSM_CFG, "cpu")
    wrong = dict(flat)
    wrong["layers/mamba/conv_w"] = wrong["layers/mamba/conv_w"].astype(
        np.float16)
    with pytest.raises(TypeError, match="expected"):
        from_numpy(wrong, SSM_CFG, "cpu")


def test_init_params_matches_reference_shapes_dtypes_and_scales():
    """mamba2-smoke in bf16: shapes and dtypes equal the JAX tree's, the
    deterministic leaves equal it (dt_bias and A_log within an ulp of
    XLA's linspace), the random ones have its std within 5%."""
    jcfg = jax_smoke("mamba2-780m")
    cfg = get_smoke("mamba2-780m")
    flat = _flatten(jax_get_model(jcfg).init(jax.random.key(0), jcfg))
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
    again = _flat_port(init_params(cfg, device="cpu", seed=0))
    assert all(torch.equal(again[k], mine[k]) for k in mine)


def test_other_families_still_raise_in_the_bridge():
    """The bridge holds the hybrid's tree (``groups/``, ``trailing/``,
    ``shared/``), the MoE decoder's (``layers/moe/``; its round trip is
    in tests/test_torch_moe.py) and enc-dec audio's (``enc_layers/``,
    ``dec_layers/``; tests/test_torch_encdec.py) and the VLM's
    (``self_groups/``, ``cross/``, ``trailing/``;
    tests/test_torch_vlm.py)."""
    moe = param_spec(get_smoke("olmoe-1b-7b"))
    assert {k for k in moe if "/moe/" in k} == {
        f"layers/moe/{w}" for w in ("router", "w_gate", "w_up", "w_down")}
    assert not any("/mlp/" in k for k in moe)
    audio = param_spec(get_smoke("whisper-tiny"))
    assert {k.split("/")[0] for k in audio} == {
        "tok_embed", "enc_layers", "dec_layers", "enc_norm", "final_norm",
        "lm_head"}
    vlm = param_spec(get_smoke("llama-3.2-vision-90b"))
    assert {k.split("/")[0] for k in vlm} == {
        "embed", "self_groups", "cross", "trailing", "final_norm",
        "lm_head"}
    assert vlm["cross/gate_attn"][0] == (1,)
    spec = param_spec(get_smoke("zamba2-1.2b"))
    assert {k.split("/")[0] for k in spec} == {
        "embed", "final_norm", "lm_head", "groups", "trailing", "shared"}


# ---------------------------------------------------------------- engine

def _prompts(seed, lens, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(int(n),)).astype(np.int32)
            for n in lens]


def test_engine_matches_jax_engine_and_greedy_generate(engine_weights):
    """tests/test_serve_engine.py:101 on both packages: 2 slots, prompts
    of 5, 9 and 6 tokens, 5 new each. The port's streams equal the JAX
    engine's and each request's greedy_generate; the trace counts equal
    the JAX engine's."""
    jcfg, jparams, params = engine_weights
    prompts = _prompts(4, (5, 9, 6))
    jeng = JaxEngine(jcfg, jparams, slots=2, max_len=64)
    eng = ServeEngine(SSM_CFG, params, slots=2, max_len=64)
    assert not eng.paged and not eng.mixed
    for e in (jeng, eng):
        for i, p in enumerate(prompts):
            e.submit(i, p, max_new=5)
    jres, res = jeng.run(), eng.run()
    for i, p in enumerate(prompts):
        seq = greedy_generate(jparams, jcfg, JaxStrategy(),
                              {"tokens": jnp.asarray(p)[None, :]}, steps=5)
        want = [int(t) for t in seq[0]]
        assert res[i].done and res[i].out == jres[i].out == want, i
    for key in ("decode_traces", "prefill_traces", "prefills",
                "decode_steps", "decode_tokens"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["decode_traces"] == 1
    assert eng.stats["prefill_traces"] == 3
    assert eng.kv_bytes() == jeng.kv_bytes()
    # the step's phase laps reach the tracer; reset keeps the trace counts
    names = {e.get("name") for e in eng.trace()["traceEvents"]}
    assert {"admit", "dispatch", "sync"} <= names
    eng.reset_stats()
    assert eng.stats["prefill_traces"] == 3 and eng.stats["prefills"] == 0


def test_engine_max_new_one_and_eos_finish_at_prefill(engine_weights):
    _, _, params = engine_weights
    eng = ServeEngine(SSM_CFG, params, slots=1, max_len=32)
    eng.submit(0, _prompts(1, (7,))[0], max_new=1)
    res = eng.run()
    assert res[0].done and len(res[0].out) == 1
    assert eng.stats["decode_steps"] == 0 and eng.active == [None]
    first = res[0].out[0]
    eos = ServeEngine(SSM_CFG, params, slots=1, max_len=32, eos_id=first)
    eos.submit(0, _prompts(1, (7,))[0], max_new=8)
    assert eos.run()[0].out == [first]


def test_engine_refuses_a_prompt_past_the_chunk_precondition(
        engine_weights):
    """A 200-token prompt at ssm_chunk 128 (200 % 128 != 0): both engines
    fail inside the request's prefill, after it left the queue."""
    jcfg, jparams, params = engine_weights
    prompt = _prompts(6, (200,))[0]
    jeng = JaxEngine(jcfg, jparams, slots=2, max_len=256)
    jeng.submit(0, prompt, max_new=2)
    with pytest.raises(AssertionError):
        jeng.step()
    eng = ServeEngine(SSM_CFG, params, slots=2, max_len=256)
    eng.submit(0, prompt, max_new=2)
    with pytest.raises(ValueError, match=re.escape("s % min(chunk, s)")):
        eng.step()
    assert len(jeng.queue) == len(eng.queue) == 0
    # 256 tokens (two chunks) and 77 (one ragged chunk) are served
    ok = ServeEngine(SSM_CFG, params, slots=2, max_len=300)
    for i, p in enumerate(_prompts(7, (256, 77))):
        ok.submit(i, p, max_new=3)
    assert all(r.done and len(r.out) == 3 for r in ok.run().values())


@pytest.mark.parametrize("kw", [{"paged": True}, {"prefix_cache": True},
                                {"lazy": True}, {"mixed": True}])
def test_engine_layout_rules_refuse_like_the_reference(engine_weights, kw):
    """The SSM family is not pageable: both engines raise ValueError."""
    jcfg, jparams, params = engine_weights
    with pytest.raises(ValueError):
        JaxEngine(jcfg, jparams, slots=2, max_len=64, **kw)
    with pytest.raises(ValueError):
        ServeEngine(SSM_CFG, params, slots=2, max_len=64, **kw)


def test_session_serves_ssm_on_cpu_and_refuses_training(engine_weights):
    _, _, params = engine_weights
    session = Session(SSM_CFG, device="cpu", params=params)
    eng = session.serve(slots=2, max_len=64)
    for i, p in enumerate(_prompts(4, (5, 9, 6))):
        eng.submit(i, p, max_new=5)
    got = {i: r.out for i, r in eng.run().items()}
    ref_eng = ServeEngine(SSM_CFG, params, slots=2, max_len=64)
    for i, p in enumerate(_prompts(4, (5, 9, 6))):
        ref_eng.submit(i, p, max_new=5)
    assert got == {i: r.out for i, r in ref_eng.run().items()}
    # the SSM family trains (tests/test_torch_train.py holds the step to
    # the reference's), and so do MoE (tests/test_torch_moe.py) and
    # enc-dec audio on batches with frames (tests/test_torch_encdec.py),
    # and the VLM on batches with images (tests/test_torch_vlm.py)
    trainer = session.train(global_batch=2, seq_len=16)
    assert trainer.params is session.params
    moe = get_smoke("olmoe-1b-7b").with_(dtype="float32")
    moe_trainer = Session(moe, device="cpu").train(global_batch=2,
                                                   seq_len=16)
    assert "moe" in moe_trainer.params["layers"]
    from repro_torch.launch.train import FramesData, ImagesData
    from repro_torch.train.trainer import TrainConfig
    audio = get_smoke("whisper-tiny").with_(dtype="float32")
    hist = Session(audio, device="cpu").train(
        TrainConfig(steps=1, log_every=1),
        data=FramesData(audio, global_batch=2, seq_len=16)).run()["history"]
    assert np.isfinite(hist[-1]["loss"])
    vlm = get_smoke("llama-3.2-vision-90b").with_(dtype="float32")
    hist = Session(vlm, device="cpu").train(
        TrainConfig(steps=1, log_every=1),
        data=ImagesData(vlm, global_batch=2, seq_len=16)).run()["history"]
    assert np.isfinite(hist[-1]["loss"])
    fresh = Session(SSM_CFG, device="cpu", seed=3)
    assert fresh.params["layers"]["mamba"]["in_proj"].shape == (2, 64, 164)


def test_launcher_serves_mamba_on_cpu(capsys):
    from repro_torch.launch import serve as launcher
    results = launcher.main(["--arch", "mamba2-780m", "--device", "cpu",
                             "--requests", "3", "--max-new", "3",
                             "--trace-level", "0"])
    assert len(results) == 3 and all(r.done and len(r.out) == 3
                                     for r in results.values())
    out = capsys.readouterr().out
    assert "split prefill/decode" in out and "plain path" in out
