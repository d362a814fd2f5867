"""The port's enc-dec audio family against the JAX package: the sinusoid
table, the plain-GeLU MLP (repro_torch/models/layers.py), the encoder,
cross-attention, forward, prefill and decode (models/encdec.py), its
params and weight bridge (params.py), its training (train/step.py,
api/session.py, launch/train.py) and the reference's per-arch smoke
checks on ``whisper-smoke``.

The same numpy inputs (from a seed) go through ``repro.models.encdec`` and
the port, on weights the reference initialised and the bridge carried
over, in float32. Tolerances: the sinusoid table bit for bit, the GeLU MLP
at 1e-6, encode and forward logits at 1e-5, prefill + decode against the
teacher-forced forward at 5e-5 (the reference's
``test_decode_consistency.py``) and against the reference's own prefill +
decode at 1e-5, the train step (remat on, 2 microbatches) at 1e-5. Each
JAX reference is built once per (config, seed) and shared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten, save_checkpoint  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.strategy import Strategy as JaxStrategy  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.strategy import Strategy  # noqa: E402
from repro_torch.launch.train import FramesData  # noqa: E402
from repro_torch.models import encdec, get_model, kvcache  # noqa: E402
from repro_torch.models.layers import mlp  # noqa: E402
from repro_torch.params import (from_numpy, init_params, load_npz,  # noqa: E402
                                param_spec)
from repro_torch.train import step  # noqa: E402
from repro_torch.train.trainer import (TrainConfig,  # noqa: E402
                                       check_kernel_limits)
from repro_torch.tree import flatten  # noqa: E402

ARCH = "whisper-tiny"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes are tiny: one intra-op thread computes them as fast,
    and the test workers running beside this one keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    kw = {"dtype": "float32", **kw}
    return jax_smoke(ARCH).with_(**kw), get_smoke(ARCH).with_(**kw)


_INITS = {}


def _jax_init(seed, jcfg):
    """``repro.models.encdec.init`` of whisper-smoke, jitted once a
    (seed, dtype)."""
    key = (seed, jcfg.dtype)
    if key not in _INITS:
        _INITS[key] = jax.jit(jed.init, static_argnums=1)(
            jax.random.key(seed), jcfg)
    return _INITS[key]


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, port cfg, JAX params, port params) at seed 0, f32."""
    jcfg, cfg = _cfgs()
    jparams = _jax_init(0, jcfg)
    return jcfg, cfg, jparams, from_numpy(_flatten(jparams), cfg, "cpu")


def _batch(cfg, seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32),
            rng.standard_normal((b, cfg.encoder_ctx, cfg.d_model))
            .astype(np.float32))


@pytest.fixture(scope="module")
def jax_outputs(pair):
    """The reference's encode, forward, prefill (28 of 32 tokens) and four
    decode steps on the dense cache, on seed 5's batch — one jit each."""
    jcfg, _, jparams, _ = pair
    toks, frames = _batch(jcfg, 5)
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    enc = jax.jit(lambda p, f: jed.encode(p, f, jcfg))(jparams, jb["frames"])
    logits, _ = jax.jit(lambda p, b: jed.forward(p, b, jcfg))(jparams, jb)

    @jax.jit
    def prefill_decode(p, b):
        cache = jed.init_cache(jcfg, 2, 32)
        lg, cache = jed.prefill(p, {"tokens": b["tokens"][:, :28],
                                    "frames": b["frames"]}, jcfg, cache)
        out = [lg]
        for i in range(4):
            lg, cache = jed.decode_step(p, cache,
                                        b["tokens"][:, 28 + i:29 + i],
                                        jnp.asarray(28 + i, jnp.int32), jcfg)
            out.append(lg)
        return jnp.concatenate(out, axis=1), cache

    steps, cache = prefill_decode(jparams, jb)
    return (toks, frames, np.asarray(enc), np.asarray(logits),
            np.asarray(steps), jax.tree.map(np.asarray, cache))


# ------------------------------------------------------------- the layers

@pytest.mark.parametrize("length,dim", [(64, 128), (1500, 384), (448, 384),
                                        (37, 10)])
def test_sinusoid_equals_reference_bit_for_bit(length, dim):
    """float64 numpy rounded once to float32, as the reference builds it
    (whisper-tiny's encoder and decoder tables among the cases)."""
    got = encdec.sinusoid(length, dim)
    want = np.asarray(jed.sinusoid(length, dim))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_gelu_mlp_matches_reference():
    """The plain-GeLU MLP (no ``w_gate``): ``jax.nn.gelu``'s tanh form,
    within 1e-6, with and without a gradient required (it never reaches
    the fused SwiGLU kernel)."""
    rng = np.random.default_rng(0)
    w = {"w_up": (rng.standard_normal((64, 256)) * 0.05).astype(np.float32),
         "w_down": (rng.standard_normal((256, 64)) * 0.05)
         .astype(np.float32)}
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    want = np.asarray(jlayers.mlp({k: jnp.asarray(v) for k, v in w.items()},
                                  jnp.asarray(x)))
    got = mlp({k: _t(v) for k, v in w.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    tw = {k: _t(v).requires_grad_(True) for k, v in w.items()}
    np.testing.assert_allclose(mlp(tw, _t(x)).detach().numpy(), want,
                               atol=1e-6, rtol=0)


# ----------------------------------------------------------------- model

def test_encode_and_forward_match_reference(pair, jax_outputs):
    """``encode`` and the decoder logits within 1e-5 of the reference's,
    remat on and off (remat changes no value); aux is 0; the model maps to
    the enc-dec module."""
    _, cfg, _, params = pair
    toks, frames, enc, logits, _, _ = jax_outputs
    assert get_model(cfg) is encdec
    got = encdec.encode(params, _t(frames), cfg)
    np.testing.assert_allclose(got.numpy(), enc, atol=1e-5, rtol=1e-5)
    for remat in (False, True):
        lg, aux = encdec.forward(params, {"tokens": _t(toks),
                                          "frames": _t(frames)}, cfg,
                                 remat=remat)
        np.testing.assert_allclose(lg.detach().numpy(), logits, atol=1e-5,
                                   rtol=1e-5)
        assert float(aux) == 0.0


def test_decode_matches_forward(pair, jax_outputs):
    """The reference's ``test_decode_consistency.py`` on the port:
    prefill of 28 tokens then 4 decode steps against the teacher-forced
    forward within 5e-5, and against the reference's own prefill + decode
    within 1e-5 — logits, the decoder K/V and the cross K/V."""
    _, cfg, _, params = pair
    toks, frames, _, logits, steps, jcache = jax_outputs
    b, s = toks.shape
    with torch.no_grad():
        cache = encdec.init_cache(cfg, b, s, device="cpu")
        lg, cache = encdec.prefill(params, {"tokens": _t(toks[:, :s - 4]),
                                            "frames": _t(frames)}, cfg, cache)
        out = [lg]
        for i in range(4):
            pos = s - 4 + i
            lg, cache = encdec.decode_step(params, cache,
                                           _t(toks[:, pos:pos + 1]), pos, cfg)
            out.append(lg)
    got = torch.cat(out, dim=1).numpy()
    np.testing.assert_allclose(got, steps, atol=1e-5, rtol=1e-5)
    for j, pos in enumerate(range(s - 5, s)):
        err = np.abs(got[:, j] - logits[:, pos]).max()
        assert err < 5e-5, (pos, err)
    for key in ("kv", "xkv"):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(cache[key][leaf].numpy(),
                                       jcache[key][leaf], atol=1e-5,
                                       rtol=1e-5, err_msg=f"{key}/{leaf}")
    assert int(cache["pos"]) == int(jcache["pos"]) == s


@pytest.fixture(scope="module")
def jax_paged_decode(pair):
    """The reference's ``decode_step`` on a paged cache: 3 rows of 2 slots
    at cursors 5, 9, 2 (page 4, tables of 4 pages; row 2 writes to the
    null page through ``wtab``), its cross K/V a dense block a row —
    inputs drawn from seed 7."""
    jcfg, cfg, jparams, _ = pair
    rng = np.random.default_rng(7)
    L, h, d = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    pool = {k: (rng.standard_normal((L, 9, 4, h, d)) * 0.5)
            .astype(np.float32) for k in ("k", "v")}
    xkv = {k: (rng.standard_normal((L, 3, cfg.encoder_ctx, h, d)) * 0.5)
           .astype(np.float32) for k in ("k", "v")}
    ptab = np.array([[3, 1, 5, 0], [3, 1, 5, 0], [2, 8, 0, 0]], np.int32)
    wtab = ptab.copy()
    wtab[2] = 0
    token = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
    pos = np.array([5, 9, 2], np.int32)
    jc = {"kv": {k: jnp.asarray(v) for k, v in pool.items()},
          "xkv": {k: jnp.asarray(v) for k, v in xkv.items()},
          "ptab": jnp.asarray(ptab), "wtab": jnp.asarray(wtab)}
    lg, out = jax.jit(lambda p, c, t, q: jed.decode_step(p, c, t, q, jcfg))(
        jparams, jc, jnp.asarray(token), jnp.asarray(pos))
    return (pool, xkv, ptab, wtab, token, pos, np.asarray(lg),
            jax.tree.map(np.asarray, out["kv"]))


def test_paged_decode_matches_reference(pair, jax_paged_decode):
    """The paged branch: every row's K/V scattered through ``wtab`` before
    any row attends through ``ptab``; logits and the pool within 1e-5 of
    the reference's. The same cross K/V as one block a slot, gathered by
    ``xslot`` a layer at a time (the engine's mixed step), gives the same
    logits."""
    _, cfg, _, params = pair
    pool, xkv, ptab, wtab, token, pos, want, want_pool = jax_paged_decode
    for xslot in (None, np.array([0, 1, 2])):
        cache = {"kv": {k: _t(v) for k, v in pool.items()},
                 "xkv": {k: _t(v) for k, v in xkv.items()},
                 "ptab": _t(ptab), "wtab": _t(wtab)}
        if xslot is not None:
            # slot blocks in another order, rows mapped back through xslot
            order = np.array([2, 0, 1])
            cache["xkv"] = {k: _t(v[:, order]) for k, v in xkv.items()}
            cache["xslot"] = _t(np.argsort(order))
        with torch.no_grad():
            lg, out = encdec.decode_step(params, cache, _t(token), _t(pos),
                                         cfg)
        np.testing.assert_allclose(lg.numpy(), want, atol=1e-5, rtol=1e-5)
        for k in ("k", "v"):
            np.testing.assert_allclose(out["kv"][k].numpy(), want_pool[k],
                                       atol=1e-5, rtol=1e-5)
        assert out["pos"].tolist() == (pos + 1).tolist()


def test_decode_clamps_positions_to_the_table_as_jax_gathers(pair):
    """A cursor past the cache width reads the sinusoid table's last row
    (JAX's gather clamps); the dense write past it is dropped, as the
    reference's scatter drops it."""
    _, cfg, _, params = pair
    rng = np.random.default_rng(9)
    token = _t(rng.integers(0, cfg.vocab_size, size=(2, 1)).astype(np.int32))
    frames = _t(rng.standard_normal((2, cfg.encoder_ctx, cfg.d_model))
                .astype(np.float32))
    with torch.no_grad():
        cache = encdec.init_cache(cfg, 2, 8, device="cpu")
        encdec.prefill(params, {"tokens": token, "frames": frames}, cfg,
                       cache)
        before = cache["kv"]["k"].clone()
        lg_far, _ = encdec.decode_step(params, cache, token,
                                       torch.tensor([7, 30]), cfg)
        assert torch.equal(cache["kv"]["k"][:, 1, :7], before[:, 1, :7])
        x_far = encdec.sinusoid(8, cfg.d_model)[
            torch.clamp(torch.tensor([7, 30]), 0, 7)]
    np.testing.assert_array_equal(x_far[0].numpy(), x_far[1].numpy())
    assert bool(torch.isfinite(lg_far).all())


# ---------------------------------------------------------------- params

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_bridge_round_trip_is_total_and_exact(dtype, tmp_path):
    """A JAX enc-dec tree through ``from_numpy`` and through a
    checkpoint: every leaf, exact (bf16 bitwise), the two stacks on their
    own depths, the plain MLP without ``w_gate``, an untied head."""
    jcfg, cfg = _cfgs(dtype=dtype)
    jparams = _jax_init(0, jcfg)
    flat = _flatten(jparams)
    port = flatten(from_numpy(flat, cfg, "cpu"))
    assert set(port) == set(flat) == set(param_spec(cfg))
    assert not any("w_gate" in k for k in port)
    assert port["enc_layers/attn/wq"].shape[0] == cfg.encoder_layers
    assert port["dec_layers/xattn/wk"].shape[0] == cfg.num_layers
    assert "lm_head" in port and "embed" not in port
    for key, arr in flat.items():
        assert str(port[key].dtype) == f"torch.{arr.dtype.name}", key
        if dtype == "bfloat16" and arr.dtype.itemsize == 2:
            np.testing.assert_array_equal(
                port[key].view(torch.int16).numpy(),
                np.asarray(arr).view(np.int16), err_msg=key)
        else:
            np.testing.assert_array_equal(port[key].float().numpy(),
                                          np.asarray(arr, np.float32),
                                          err_msg=key)
    loaded = flatten(load_npz(save_checkpoint(tmp_path, 1, jparams), cfg,
                              "cpu"))
    assert all(torch.equal(loaded[k], port[k]) for k in port)
    flat.pop("enc_norm")
    with pytest.raises(KeyError, match="enc_norm"):
        from_numpy(flat, cfg, "cpu")


def test_init_params_matches_reference_shapes_dtypes_and_scales():
    """whisper-smoke in bf16 (its own dtype): shapes and dtypes equal the
    JAX tree's, norms are ones, the random leaves' std within 5% of the
    reference's (``wo`` and ``w_down`` at 0.02 / sqrt(2L) in both
    stacks), or within five standard errors on a leaf too small for 5%."""
    jcfg, cfg = jax_smoke(ARCH), get_smoke(ARCH)
    flat = _flatten(_jax_init(0, jcfg))
    mine = flatten(init_params(cfg, device="cpu", seed=0))
    spec = param_spec(cfg)
    assert set(mine) == set(flat)
    for key, arr in flat.items():
        t, a = mine[key], np.asarray(arr, np.float32)
        assert tuple(t.shape) == arr.shape, key
        assert str(t.dtype) == f"torch.{arr.dtype.name}", key
        if isinstance(spec[key][2], str):
            np.testing.assert_array_equal(t.float().numpy(), a, err_msg=key)
        else:
            tol = max(0.05, 5 / np.sqrt(2 * a.size))
            assert abs(t.float().std().item() / a.std() - 1) < tol, key
    deep = 0.02 / np.sqrt(2 * cfg.num_layers)
    for stack in ("enc_layers", "dec_layers"):
        assert spec[f"{stack}/mlp/w_down"][2] == spec[f"{stack}/attn/wo"][2] \
            == pytest.approx(deep)


def test_whisper_tiny_param_count():
    """whisper-tiny uncut: 56.36 M parameters (no tied head): the config's
    analytical count plus the two final norms (``enc_norm``,
    ``final_norm``) it leaves out."""
    cfg = get_config(ARCH)
    n = sum(int(np.prod(shape)) for shape, _, _ in param_spec(cfg).values())
    assert n == cfg.param_count() + 2 * cfg.d_model == 56_355_840


# -------------------------------------------------------------- training

@pytest.fixture(scope="module")
def jax_train_step(pair):
    """The reference's train step on whisper-smoke in float32 with remat
    and 2 microbatches (4 x 32 tokens, 4 frame blocks), and each
    microbatch's loss gradients — one jit."""
    jcfg, cfg, jparams, _ = pair
    toks, frames = _batch(cfg, 8, b=4)
    strat = JaxStrategy(remat=True, microbatches=2, attn_impl="auto",
                        dtype="float32")
    loss_fn = jstep.make_loss_fn(jcfg, strat)
    train_step = jstep.make_train_step(jcfg, strat, lr=3e-4)

    @jax.jit
    def grads_and_step(p, b):
        grads = [jax.grad(lambda q: loss_fn(
            q, {k: v[i:i + 2] for k, v in b.items()})[0])(p) for i in (0, 2)]
        return (grads,) + train_step(p, jstep.init_opt_state(p, strat), b)

    grads, new_p, _, metrics = grads_and_step(
        jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    return (toks, frames, [_flatten(g) for g in grads], _flatten(new_p),
            {k: float(v) for k, v in metrics.items()})


def test_train_step_matches_reference(pair, jax_train_step):
    """remat on, 2 microbatches (each slices tokens and frames): each
    microbatch's loss gradients within 1e-5 of ``jax.grad``'s; one AdamW
    step's loss and grad norm within 1e-5 (relative), and its params
    within 1e-5 where the reference's gradient exceeds 2e-6."""
    jcfg, cfg, jparams, _ = pair
    toks, frames, jgrads, jnew, jmetrics = jax_train_step
    strat = Strategy(remat=True, microbatches=2, attn_impl="auto",
                     dtype="float32")
    params = from_numpy(_flatten(jparams), cfg, "cpu")
    leaves = flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss_fn = step.make_loss_fn(cfg, strat)
    for i, jg in zip((0, 2), jgrads):
        total, _ = loss_fn(params, {"tokens": _t(toks[i:i + 2]),
                                    "frames": _t(frames[i:i + 2])})
        grads = torch.autograd.grad(total, list(leaves.values()))
        for key, g in zip(leaves, grads):
            np.testing.assert_allclose(g.numpy(), jg[key], atol=1e-5,
                                       rtol=1e-5, err_msg=key)
    new, _, metrics = step.make_train_step(cfg, strat, lr=3e-4)(
        params, step.init_opt_state(params, strat),
        {"tokens": _t(toks), "frames": _t(frames)})
    for k in ("loss", "grad_norm"):
        assert float(metrics[k]) == pytest.approx(jmetrics[k], rel=1e-5,
                                                  abs=1e-5), k
    assert float(metrics["aux_loss"]) == jmetrics["aux_loss"] == 0.0
    live_any = 0
    for key, p in flatten(new).items():
        live = (np.abs(jgrads[0][key]) + np.abs(jgrads[1][key])) > 2e-6
        live_any += int(live.sum())
        np.testing.assert_allclose(p.detach().numpy()[live],
                                   jnew[key][live], atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    assert live_any > 0


def test_session_trains_on_frames_and_refuses_token_only_data(tmp_path):
    """``Session.train`` on a ``data=`` object whose batches carry frames:
    two steps with finite losses that move the encoder and the cross
    attention, a checkpoint, and a resume bit for bit. Without one the
    first step raises ``KeyError`` naming frames in the model's forward,
    where the reference's fails."""
    _, cfg = _cfgs()
    strat = Strategy(remat=True, dtype="float32")
    tc = TrainConfig(steps=2, lr=1e-3, log_every=1, checkpoint_every=2,
                     checkpoint_dir=str(tmp_path))
    data = FramesData(cfg, global_batch=2, seq_len=16, seed=3)
    assert data.batch(0)["frames"].shape == (2, cfg.encoder_ctx, cfg.d_model)
    session = Session(cfg, strategy=strat, device="cpu", seed=3)
    init = {k: v.detach().clone() for k, v in flatten(session.params).items()}
    hist = session.train(tc, data=data).run()["history"]
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    trained = flatten(session.params)
    for key in ("enc_layers/attn/wq", "dec_layers/xattn/wk"):
        assert not torch.equal(trained[key], init[key]), key
    other = Session(cfg, strategy=strat, device="cpu", seed=9)
    resumed = other.train(tc, data=data, restore=True)
    assert resumed.step == 2
    for key, p in flatten(other.params).items():
        assert torch.equal(p, trained[key]), key
    bare = Session(cfg, strategy=strat, device="cpu").train(global_batch=2,
                                                            seq_len=16)
    with pytest.raises(KeyError, match="frames"):
        bare.run(1)


def test_train_launcher_runs_whisper_on_cpu(capsys):
    from repro_torch.launch import train as launcher
    out = launcher.main(["--device", "cpu", "--arch", ARCH, "--steps", "2",
                         "--global-batch", "2", "--seq", "16"])
    assert out["history"][-1]["step"] == 2
    assert np.isfinite(out["history"][-1]["loss"])
    assert "tokens/s on cpu" in capsys.readouterr().out


def test_trainer_checks_flash_limits_for_audio():
    """On a CUDA device (no card needed to refuse) the enc-dec family's
    flash limits are checked before any parameter is made; whisper-tiny's
    heads (6 x 64) pass."""
    odd = get_smoke(ARCH).with_(head_dim=20)
    with pytest.raises(ValueError, match="flash-attention kernel"):
        check_kernel_limits(odd, Strategy(), "cuda")
    with pytest.raises(ValueError, match="flash-attention kernel"):
        Session(odd, device="cuda").train()
    check_kernel_limits(odd, Strategy(), "cpu")
    check_kernel_limits(get_config(ARCH), Strategy(), "cuda")


# ------------------------------------------------- tests/test_smoke_archs.py

def _smoke_batch(cfg, seed, b=2, s=32):
    toks, frames = _batch(cfg, seed, b, s)
    return {"tokens": _t(toks), "frames": _t(frames)}


def test_smoke_forward_shapes_and_finite():
    """``test_forward_shapes_and_finite[whisper-tiny]``: the smoke config
    in its own dtype (bf16), random weights, logits (2, 32, V) finite."""
    cfg = get_smoke(ARCH)
    assert cfg.num_layers <= 4 and cfg.d_model <= 512
    params = init_params(cfg, device="cpu", seed=0)
    with torch.no_grad():
        logits, aux = get_model(cfg).forward(params, _smoke_batch(cfg, 0),
                                             cfg)
    assert logits.shape == (2, 32, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    assert bool(torch.isfinite(aux))


def test_smoke_one_train_step():
    """``test_one_train_step[whisper-tiny]``: remat, 2 microbatches, bf16
    — finite loss and grad norm, and the params change."""
    cfg = get_smoke(ARCH)
    params = init_params(cfg, device="cpu", seed=1)
    before = {k: v.detach().clone() for k, v in flatten(params).items()}
    st = Strategy(remat=True, microbatches=2, dtype=cfg.dtype)
    new, _, metrics = step.make_train_step(cfg, st, lr=1e-3)(
        params, step.init_opt_state(params, st), _smoke_batch(cfg, 1, b=4))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    delta = max(float((p.detach().float() - before[k].float()).abs().max())
                for k, p in flatten(new).items())
    assert delta > 0


def test_smoke_decode_step_shapes():
    """``test_decode_step_shapes[whisper-tiny]``: one decode step at
    position 0 on a fresh 64-token cache, logits (2, 1, V) finite."""
    cfg = get_smoke(ARCH)
    params = init_params(cfg, device="cpu", seed=2)
    cache = encdec.init_cache(cfg, 2, 64, device="cpu")
    assert cache["xkv"]["k"].shape == (cfg.num_layers, 2, cfg.encoder_ctx,
                                       cfg.num_kv_heads, cfg.head_dim)
    with torch.no_grad():
        logits, _ = encdec.decode_step(params, cache,
                                       torch.zeros((2, 1), dtype=torch.int32),
                                       0, cfg)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())


def test_fit_prefill_keeps_prompt_kv_at_the_front(pair):
    """The prefill's K/V lands at positions 0..S-1 of a longer cache (the
    tail zero), as ``kvcache.fit_prefill`` lays out a linear cache."""
    _, cfg, _, params = pair
    toks, frames = _batch(cfg, 4, b=1, s=6)
    with torch.no_grad():
        cache = encdec.init_cache(cfg, 1, 10, device="cpu")
        encdec.prefill(params, {"tokens": _t(toks), "frames": _t(frames)},
                       cfg, cache)
    k = cache["kv"]["k"]
    assert bool((k[:, :, 6:] == 0).all()) and bool((k[:, :, :6] != 0).any())
    assert kvcache.fit_prefill(k[0][:, :6], 10).shape == k[0].shape
