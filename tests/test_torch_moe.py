"""The port's MoE family against the JAX package: routing, dispatch and the
expert FFN (repro_torch/models/moe.py), the MoE branch of the decoder
block (models/transformer.py), its params (params.py) and its training
(train/step.py, api/session.py, launch/train.py).

The same numpy inputs (from a seed) go through ``repro.models.moe`` /
``repro.models.transformer`` and the port, on weights the reference
initialised (or numpy drew) and the bridge carried over, in float32.
Tolerances: routing is held exactly (expert ids, the capacity mask and
the dispatch rows; capacities as integers), gates and the aux loss at
1e-6, the FFN, logits and the train step at 1e-5 (another summation
order), prefill + decode against the teacher-forced forward at 5e-5 (the
reference's ``test_decode_consistency.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten, save_checkpoint  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.strategy import Strategy as JaxStrategy  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.strategy import Strategy  # noqa: E402
from repro_torch.models import get_model, moe, transformer  # noqa: E402
from repro_torch.models.layers import mlp  # noqa: E402
from repro_torch.params import (from_numpy, init_params, load_npz,  # noqa: E402
                                param_spec)
from repro_torch.train import step  # noqa: E402
from repro_torch.train.trainer import (TrainConfig,  # noqa: E402
                                       check_kernel_limits)
from repro_torch.tree import flatten  # noqa: E402

MOE_ARCHS = ("olmoe-1b-7b", "kimi-k2-1t-a32b")


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


def _cfgs(arch="olmoe-1b-7b", **kw):
    """(JAX cfg, port cfg): the arch's smoke config, in float32 unless
    ``dtype`` says otherwise."""
    kw = {"dtype": "float32", **kw}
    return jax_smoke(arch).with_(**kw), get_smoke(arch).with_(**kw)


def _moe_weights(cfg, seed):
    """One layer's MoE leaves at the reference's scales, drawn by numpy."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    deep = 0.02 / np.sqrt(2 * cfg.num_layers)
    return {k: (rng.standard_normal(shape) * s).astype(np.float32)
            for k, shape, s in (("router", (d, e), 0.02),
                                ("w_gate", (e, d, f), 0.02),
                                ("w_up", (e, d, f), 0.02),
                                ("w_down", (e, f, d), deep))}


def _both(w):
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: _t(v) for k, v in w.items()})


#: the reference's MoE FFN under ``jax.jit`` (one compile a shape and
#: config, where eager dispatch compiles each primitive)
_jax_moe_ffn = jax.jit(jmoe.moe_ffn, static_argnums=2)


def _jax_dispatch(idx, cfg, cap):
    """The reference's slot assignment (``moe.py:72-80``), by its jnp
    ops: each entry's row in the dispatch buffer and its capacity mask."""
    flat_e = idx.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, cfg.num_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1,
                              flat_e[:, None], axis=1)[:, 0]
    keep = pos < cap
    return np.asarray(jnp.where(keep, flat_e * cap + pos, 0)), \
        np.asarray(keep)


_INITS = {}


def _jax_init(arch, seed, jcfg):
    """``repro.models.transformer.init`` of the arch's smoke config at
    ``jcfg``'s dtype, jitted once an (arch, seed, dtype): the capacity
    factor shapes no weight."""
    key = (arch, seed, jcfg.dtype)
    if key not in _INITS:
        _INITS[key] = jax.jit(jtr.init, static_argnums=1)(
            jax.random.key(seed), jcfg)
    return _INITS[key]


def _pair(arch="olmoe-1b-7b", seed=0, **kw):
    """(JAX cfg, port cfg, JAX params, port params) on the same weights."""
    jcfg, cfg = _cfgs(arch, **kw)
    jparams = _jax_init(arch, seed, jcfg)
    return jcfg, cfg, jparams, from_numpy(_flatten(jparams), cfg, "cpu")


# --------------------------------------------------------------- routing

@pytest.mark.parametrize("cf", [0.05, 1.25, 16.0])
def test_router_and_dispatch_match_reference(cf):
    """``router_topk`` and the slot assignment on 256 tokens: gates and
    aux within 1e-6, expert ids, capacity mask and dispatch rows exact —
    at a capacity factor that drops most entries, the default, and one
    that drops none. The reference's own checks hold too (gates sum to
    1, aux >= 1 up to rounding)."""
    jcfg, cfg = _cfgs(moe_capacity_factor=cf)
    jw, w = _both(_moe_weights(cfg, 0))
    x = np.random.default_rng(1).standard_normal(
        (256, cfg.d_model)).astype(np.float32)
    jg, jidx, jaux = jmoe.router_topk(jw["router"], jnp.asarray(x), jcfg)
    gates, idx, aux = moe.router_topk(w["router"], _t(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=0)
    assert abs(float(aux) - float(jaux)) < 1e-6
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, atol=1e-6)
    assert gates.shape == (256, cfg.experts_per_token)
    assert float(aux) >= 0.99
    cap = moe.capacity(256, cfg)
    assert cap == jmoe.capacity(256, jcfg)
    dest, keep = moe.dispatch(idx, cfg, cap)
    jdest, jkeep = _jax_dispatch(jidx, jcfg, cap)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(dest.numpy(), jdest)
    assert (cf < 1) == (not bool(keep.all()))


def test_topk_ties_follow_lax_top_k():
    """Equal probabilities: ``jax.lax.top_k`` puts the lower expert index
    first, and so must the port. The router's columns come in equal pairs
    and one token is all zeros (every expert equal); the values are small
    multiples of powers of two, so every product and sum is exact in fp32
    and the ties are exact in both packages, whatever the summation
    order."""
    jcfg, cfg = _cfgs(num_experts=8, experts_per_token=4)
    rng = np.random.default_rng(3)
    half = rng.integers(-4, 5, size=(cfg.d_model, 4)).astype(np.float32)
    router = np.repeat(half, 2, axis=1) / 64.0            # cols 2i == 2i+1
    x = rng.integers(-2, 3, size=(64, cfg.d_model)).astype(np.float32) / 8
    x[5] = 0.0
    jg, jidx, jaux = jmoe.router_topk(jnp.asarray(router), jnp.asarray(x),
                                      jcfg)
    gates, idx, aux = moe.router_topk(_t(router), _t(x), cfg)
    jidx = np.asarray(jidx)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    assert list(jidx[5]) == [0, 1, 2, 3]
    # every row's pair of equal columns comes out in index order
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ router, axis=-1))
    ties = sum(probs[t, jidx[t, j]] == probs[t, jidx[t, j + 1]]
               for t in range(64) for j in range(3))
    assert ties >= 64
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), atol=1e-6)
    assert abs(float(aux) - float(jaux)) < 1e-6


CAPACITY_CASES = {
    "olmoe-full": ("olmoe-1b-7b", "full", {}),
    "kimi-full": ("kimi-k2-1t-a32b", "full", {}),
    "olmoe-smoke": ("olmoe-1b-7b", "smoke", {}),
    "olmoe-smoke-cf2": ("olmoe-1b-7b", "smoke",
                        {"moe_capacity_factor": 2.0}),
    "olmoe-smoke-cf0.05": ("olmoe-1b-7b", "smoke",
                           {"moe_capacity_factor": 0.05}),
    "kimi-smoke-cf16": ("kimi-k2-1t-a32b", "smoke",
                        {"moe_capacity_factor": 16.0}),
}


@pytest.mark.parametrize("case", sorted(CAPACITY_CASES))
def test_capacity_equals_reference(case):
    """Capacity over token counts 1-4096 and the serving shapes (a mixed
    step's 256 rows, 4 decode slots, a 4096-token training row): the
    reference's integer everywhere, a multiple of 8 at least 8, and at
    least ``T * k / E`` where ``cf >= 1`` (``test_capacity_rounding``)."""
    arch, size, kw = CAPACITY_CASES[case]
    jcfg = (jax_config if size == "full" else jax_smoke)(arch).with_(**kw)
    cfg = (get_config if size == "full" else get_smoke)(arch).with_(**kw)
    for t in list(range(1, 300)) + [511, 512, 1000, 1024, 2048, 4096]:
        c = moe.capacity(t, cfg)
        assert c == jmoe.capacity(t, jcfg), t
        assert c % 8 == 0 and c >= 8
        if cfg.moe_capacity_factor >= 1:
            assert c >= t * cfg.experts_per_token / cfg.num_experts


# ------------------------------------------------------------- the FFN

def test_single_expert_equals_dense_mlp():
    """E = 1, k = 1: the MoE FFN is the dense SwiGLU on the same weights
    (1e-5), and equals the reference's MoE FFN (1e-5)."""
    jcfg, cfg = _cfgs(num_experts=1, experts_per_token=1,
                      moe_capacity_factor=2.0)
    jw, w = _both(_moe_weights(cfg, 1))
    x = (np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)) * 0.5).astype(np.float32)
    out, _ = moe.moe_ffn(w, _t(x), cfg)
    dense = mlp({k: w[k][0] for k in ("w_gate", "w_up", "w_down")}, _t(x))
    np.testing.assert_allclose(out.numpy(), dense.numpy(), atol=1e-5,
                               rtol=1e-5)
    jout, _ = _jax_moe_ffn(jw, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)


def test_capacity_drops_tokens_as_the_reference():
    """cf 0.05 drops entries, cf 16 none: both outputs and aux losses
    equal the reference's (1e-5), the dropped run differs from the
    undropped one and is smaller on average (the reference's checks)."""
    outs = {}
    for cf in (0.05, 16.0):
        jcfg, cfg = _cfgs(moe_capacity_factor=cf)
        jw, w = _both(_moe_weights(cfg, 2))
        x = np.random.default_rng(2).standard_normal(
            (4, 64, cfg.d_model)).astype(np.float32)
        out, aux = moe.moe_ffn(w, _t(x), cfg)
        jout, jaux = _jax_moe_ffn(jw, jnp.asarray(x), jcfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=1e-5, rtol=1e-5)
        assert abs(float(aux) - float(jaux)) < 1e-6
        outs[cf] = out
    assert float((outs[0.05] - outs[16.0]).abs().max()) > 1e-4
    assert float(outs[0.05].abs().mean()) < float(outs[16.0].abs().mean())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_permutation_equivariance(seed):
    """No drops (cf 16): permuting the tokens permutes the outputs
    (2e-5, the reference's tolerance), and the output equals the
    reference's (1e-5)."""
    jcfg, cfg = _cfgs(moe_capacity_factor=16.0)
    jw, w = _both(_moe_weights(cfg, 10 + seed))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 32, cfg.d_model)).astype(np.float32)
    perm = rng.permutation(32)
    out, _ = moe.moe_ffn(w, _t(x), cfg)
    out_p, _ = moe.moe_ffn(w, _t(x[:, perm]), cfg)
    np.testing.assert_allclose(out[:, perm].numpy(), out_p.numpy(),
                               atol=2e-5, rtol=2e-5)
    jout, _ = _jax_moe_ffn(jw, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)


def test_gradients_reach_every_leaf_and_the_source():
    """Autograd through dispatch and combine: the input, the router (via
    the gates and the aux loss) and every expert weight get the
    reference's gradient (1e-5)."""
    jcfg, cfg = _cfgs()
    w = _moe_weights(cfg, 4)
    x = np.random.default_rng(4).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, jcfg)
        return jnp.sum(out * out) + aux

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    tw = {k: _t(v).requires_grad_(True) for k, v in w.items()}
    tx = _t(x).requires_grad_(True)
    out, aux = moe.moe_ffn(tw, tx, cfg)
    (out * out).sum().add(aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]),
                               atol=1e-5, rtol=1e-5)
    for k in w:
        np.testing.assert_allclose(tw[k].grad.numpy(), np.asarray(jg[0][k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------- params

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_bridge_round_trip_is_total_and_exact(dtype, tmp_path):
    """A JAX MoE tree (olmoe-smoke) through ``from_numpy`` and through a
    checkpoint: every leaf, exact (bf16 bitwise), the router in fp32 and
    the experts stacked (L, E, ...)."""
    jcfg, cfg = _cfgs(dtype=dtype)
    jparams = _jax_init("olmoe-1b-7b", 0, jcfg)
    flat = _flatten(jparams)
    port = flatten(from_numpy(flat, cfg, "cpu"))
    assert set(port) == set(flat) == set(param_spec(cfg))
    assert "layers/mlp/w_gate" not in port
    assert port["layers/moe/router"].dtype == torch.float32
    assert port["layers/moe/w_down"].shape == (
        cfg.num_layers, cfg.num_experts, cfg.d_ff, cfg.d_model)
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


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_matches_reference_shapes_dtypes_and_scales(arch):
    """The smoke config in bf16 (its own dtype): shapes and dtypes equal
    the JAX tree's, norms are ones, the random leaves' std within 5% of
    the reference's (``w_down`` at 0.02 / sqrt(2L)), or within five
    standard errors of a std estimate (``5 / sqrt(2 n)``) on a leaf of n
    values too small for 5% (the smoke router has 1,024)."""
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    flat = _flatten(_jax_init(arch, 0, jcfg))
    mine = flatten(init_params(cfg, device="cpu", seed=0))
    assert set(mine) == set(flat)
    for key, arr in flat.items():
        t, a = mine[key], np.asarray(arr, np.float32)
        assert tuple(t.shape) == arr.shape, key
        assert str(t.dtype) == f"torch.{arr.dtype.name}", key
        if isinstance(param_spec(cfg)[key][2], str):
            np.testing.assert_array_equal(t.float().numpy(), a, err_msg=key)
        else:
            tol = max(0.05, 5 / np.sqrt(2 * a.size))
            assert abs(t.float().std().item() / a.std() - 1) < tol, key


# ----------------------------------------------------------------- model

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_and_aux_match_jax(arch):
    """2 x 32 tokens at the default capacity factor (entries drop):
    logits and aux within 1e-5 of the reference's, remat on and off (remat
    changes no value); the model maps to the decoder module."""
    jcfg, cfg, jparams, params = _pair(arch)
    assert get_model(cfg) is transformer
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    want, jaux = jax.jit(lambda p_, t: jtr.forward(p_, {"tokens": t},
                                                   jcfg))(
        jparams, jnp.asarray(tokens))
    for remat in (False, True):
        got, aux = transformer.forward(params, {"tokens": _t(tokens)}, cfg,
                                       remat=remat)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        assert abs(float(aux) - float(jaux)) < 1e-5
        assert float(aux) > cfg.num_layers * 0.99


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_forward(arch):
    """The reference's ``test_decode_consistency.py`` on the port: no-drop
    capacity (cf 16), prefill of 28 tokens then 4 decode steps against
    the teacher-forced forward, within 5e-5."""
    _, cfg, _, params = _pair(arch, moe_capacity_factor=16.0)
    b, s = 2, 32
    toks = _t(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32))
    with torch.no_grad():
        full, _ = transformer.forward(params, {"tokens": toks}, cfg)
        cache = transformer.init_cache(cfg, b, s, device="cpu")
        lg, cache = transformer.prefill(params, {"tokens": toks[:, :s - 4]},
                                        cfg, cache)
        assert float((lg[:, 0] - full[:, s - 5]).abs().max()) < 5e-5
        for i in range(4):
            pos = s - 4 + i
            lg, cache = transformer.decode_step(
                params, cache, toks[:, pos:pos + 1], pos, cfg)
            err = float((lg[:, 0] - full[:, pos]).abs().max())
            assert err < 5e-5, (pos, err)


# -------------------------------------------------------------- training

@pytest.fixture(scope="module")
def jax_moe_step():
    """The reference's train step on olmoe-smoke in float32 with 2
    microbatches (4 x 32 tokens: 64 a microbatch, capacity 40, entries
    drop), and each microbatch's loss gradients — one jit. Remat off: it
    changes no value, and the port's step runs with it on."""
    jcfg, cfg, jparams, _ = _pair("olmoe-1b-7b", seed=4)
    tokens = np.random.default_rng(8).integers(
        0, cfg.vocab_size, size=(4, 32)).astype(np.int32)
    strat = JaxStrategy(remat=False, microbatches=2, attn_impl="auto",
                        dtype="float32")
    loss_fn = jstep.make_loss_fn(jcfg, strat)
    train_step = jstep.make_train_step(jcfg, strat, lr=3e-4)

    @jax.jit
    def grads_and_step(p, toks):
        grads = [jax.grad(lambda q: loss_fn(q, {"tokens": toks[i:i + 2]})[0])(p)
                 for i in (0, 2)]
        return (grads,) + train_step(p, jstep.init_opt_state(p, strat),
                                     {"tokens": toks})

    grads, new_p, _, metrics = grads_and_step(jparams, jnp.asarray(tokens))
    return (cfg, tokens, _flatten(jparams), [_flatten(g) for g in grads],
            _flatten(new_p), {k: float(v) for k, v in metrics.items()})


def test_train_step_matches_reference(jax_moe_step):
    """remat on, 2 microbatches: each microbatch's loss gradients (router
    aux included) within 1e-5 of ``jax.grad``'s; one AdamW step's loss,
    aux loss and grad norm within 1e-5 (relative), and its params within
    1e-5 where the reference's gradient exceeds 1e-6."""
    cfg, tokens, jflat, jgrads, jnew, jmetrics = jax_moe_step
    strat = Strategy(remat=True, microbatches=2, attn_impl="auto",
                     dtype="float32")
    params = from_numpy(jflat, cfg, "cpu")
    leaves = flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss_fn = step.make_loss_fn(cfg, strat)
    for i, jg in zip((0, 2), jgrads):
        total, _ = loss_fn(params, {"tokens": _t(tokens[i:i + 2])})
        grads = torch.autograd.grad(total, list(leaves.values()))
        for key, g in zip(leaves, grads):
            np.testing.assert_allclose(g.numpy(), jg[key], atol=1e-5,
                                       rtol=1e-5, err_msg=key)
    new, _, metrics = step.make_train_step(cfg, strat, lr=3e-4)(
        params, step.init_opt_state(params, strat), {"tokens": _t(tokens)})
    for k in ("loss", "aux_loss", "grad_norm"):
        assert float(metrics[k]) == pytest.approx(jmetrics[k], rel=1e-5,
                                                  abs=1e-5), k
    assert jmetrics["aux_loss"] > 1.9          # 2 layers, each >= ~1
    live_any = 0
    for key, p in flatten(new).items():
        live = (np.abs(jgrads[0][key]) + np.abs(jgrads[1][key])) > 2e-6
        live_any += int(live.sum())
        np.testing.assert_allclose(p.detach().numpy()[live],
                                   jnew[key][live], atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    assert live_any > 0


def test_session_trains_moe_checkpoints_and_restores(tmp_path):
    """``Session.train`` on the CPU for olmoe-smoke: two steps with finite
    losses and aux losses that move the params (the router too), a
    checkpoint, and a fresh session that resumes from it bit for bit."""
    _, cfg = _cfgs()
    strat = Strategy(remat=True, dtype="float32")
    tc = TrainConfig(steps=2, lr=1e-3, log_every=1, checkpoint_every=2,
                     checkpoint_dir=str(tmp_path))
    session = Session(cfg, strategy=strat, device="cpu", seed=3)
    init = {k: v.detach().clone() for k, v in flatten(session.params).items()}
    hist = session.train(tc, global_batch=2, seq_len=32).run()["history"]
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) and h["aux_loss"] > 1.9
               for h in hist)
    trained = flatten(session.params)
    assert not torch.equal(trained["layers/moe/router"],
                           init["layers/moe/router"])
    other = Session(cfg, strategy=strat, device="cpu", seed=9)
    resumed = other.train(tc, global_batch=2, seq_len=32, restore=True)
    assert resumed.step == 2
    for key, p in flatten(other.params).items():
        assert torch.equal(p, trained[key]), key


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_launcher_runs_moe_on_cpu(arch, capsys):
    from repro_torch.launch import train as launcher
    out = launcher.main(["--device", "cpu", "--arch", arch, "--steps", "2",
                         "--global-batch", "2", "--seq", "32"])
    assert out["history"][-1]["step"] == 2
    assert np.isfinite(out["history"][-1]["loss"])
    assert "tokens/s on cpu" in capsys.readouterr().out


def test_trainer_checks_flash_limits_for_moe():
    """On a CUDA device (no card needed to refuse) an MoE config's flash
    limits are checked before any parameter is made; OLMoE's heads
    (16 x 128) pass."""
    odd = get_smoke("olmoe-1b-7b").with_(head_dim=20)
    with pytest.raises(ValueError, match="flash-attention kernel"):
        check_kernel_limits(odd, Strategy(), "cuda")
    with pytest.raises(ValueError, match="flash-attention kernel"):
        Session(odd, device="cuda").train()
    check_kernel_limits(odd, Strategy(), "cpu")
    check_kernel_limits(get_config("olmoe-1b-7b"), Strategy(), "cuda")
