"""The port's VLM family against the JAX package: the gated
cross-attention decoder (models/vlm.py), its params and weight bridge
(params.py), its training (train/step.py, api/session.py,
launch/train.py) and the reference's per-arch smoke checks on
``llama-vision-smoke``.

The same numpy inputs (from a seed) go through ``repro.models.vlm`` and
the port, on weights the reference initialised and the bridge carried
over, in float32, with both gates of every cross layer open (1.0, as
tests/test_serve_vlm.py opens them) unless a test is about the gates:
closed, a broken cross-attention would pass. Two configs: the smoke
config (3 layers = one group of 2 self layers and a cross layer, ``rest
== 0``: the tree holds one unused trailing layer) and a ``rest > 0``
variant (4 layers: one group and one trailing self layer). Tolerances:
forward logits at 1e-5, prefill + decode against the teacher-forced
forward at 5e-5 (the reference's ``test_decode_consistency.py``) and
against the reference's own prefill + decode and caches at 1e-5, the
train step (remat on, 2 microbatches) at 1e-5. Each JAX reference is
built once per (config, seed) and shared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten, save_checkpoint  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.strategy import Strategy as JaxStrategy  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.strategy import Strategy  # noqa: E402
from repro_torch.launch.train import ImagesData  # noqa: E402
from repro_torch.models import get_model, vlm  # noqa: E402
from repro_torch.params import (from_numpy, init_params, load_npz,  # noqa: E402
                                param_spec)
from repro_torch.train import step  # noqa: E402
from repro_torch.train.trainer import (TrainConfig,  # noqa: E402
                                       check_kernel_limits)
from repro_torch.tree import flatten  # noqa: E402

ARCH = "llama-3.2-vision-90b"
#: name -> config overrides: the smoke config (rest 0), a rest > 0 variant
#: and the smoke config on a sliding window of 16 (the ring cache)
CONFIGS = {"rest0": {}, "rest1": dict(num_layers=4),
           "ring": dict(sliding_window=16)}


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


def _cfgs(name="rest0", **kw):
    kw = {"dtype": "float32", **CONFIGS[name], **kw}
    return jax_smoke(ARCH).with_(**kw), get_smoke(ARCH).with_(**kw)


_INITS = {}


def _jax_init(seed, jcfg, *, gates_open=True):
    """``repro.models.vlm.init`` in float32, jitted once a (seed, depth),
    with both gates of every cross layer set to 1.0 (``gates_open``) or
    left at their init of 0. Another dtype's tree is that one cast leaf by
    leaf to the dtypes the reference's init gives (``jax.eval_shape``):
    its ``dense_init`` draws in float32 and casts, so the two agree bit
    for bit."""
    key = (seed, jcfg.num_layers)
    if key not in _INITS:
        f32 = jax_smoke(ARCH).with_(dtype="float32",
                                    num_layers=jcfg.num_layers)
        _INITS[key] = jax.jit(jvlm.init, static_argnums=1)(
            jax.random.key(seed), f32)
    params = _INITS[key]
    if jcfg.dtype != "float32":
        shapes = jax.eval_shape(lambda k: jvlm.init(k, jcfg),
                                jax.random.key(seed))
        params = jax.tree.map(lambda a, sd: a.astype(sd.dtype), params,
                              shapes)
    if not gates_open:
        return params
    cross = dict(params["cross"],
                 gate_attn=jnp.ones_like(params["cross"]["gate_attn"]),
                 gate_mlp=jnp.ones_like(params["cross"]["gate_mlp"]))
    return dict(params, cross=cross)


_PAIRS = {}


def _pair(name):
    """(JAX cfg, port cfg, JAX params, port params) at seed 0, f32, gates
    open."""
    if name not in _PAIRS:
        jcfg, cfg = _cfgs(name)
        jparams = _jax_init(0, jcfg)
        _PAIRS[name] = (jcfg, cfg, jparams,
                        from_numpy(_flatten(jparams), cfg, "cpu"))
    return _PAIRS[name]


def _batch(cfg, seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32),
            rng.standard_normal((b, cfg.num_image_tokens, cfg.d_model))
            .astype(np.float32))


_OUTPUTS = {}
_RUNS = {}


def _prompt_len(jcfg):
    """28 tokens of 32 prefilled; 20 on the ring, past its window and not
    a multiple of it."""
    return 20 if jcfg.sliding_window else 28


def _jax_run(name):
    """The reference's forward on a (2 x 32)-token batch, and its prefill
    of the first ``_prompt_len`` tokens with 4 decode steps (a scan) on a
    32-position cache — one function of (params, batch), jitted once a
    config."""
    if name not in _RUNS:
        jcfg = _pair(name)[0]
        p = _prompt_len(jcfg)

        def run(q, b):
            logits, _ = jvlm.forward(q, b, jcfg)
            cache = jvlm.init_cache(jcfg, 2, 32)
            lg, cache = jvlm.prefill(q, {"tokens": b["tokens"][:, :p],
                                         "image_embeds": b["image_embeds"]},
                                     jcfg, cache)

            def step(c, i):
                tok = jax.lax.dynamic_slice_in_dim(b["tokens"], p + i, 1, 1)
                out, c = jvlm.decode_step(q, c, tok, p + i, jcfg)
                return c, out[:, 0]

            cache, outs = jax.lax.scan(step, cache, jnp.arange(4))
            steps = jnp.concatenate([lg, outs.transpose(1, 0, 2)], axis=1)
            return logits, steps, cache

        _RUNS[name] = jax.jit(run)
    return _RUNS[name]


def _jax_outputs(name):
    """``_jax_run`` on seed 5's batch: the forward's logits, the prefill +
    decode logits and the cache after them, made once."""
    if name not in _OUTPUTS:
        jcfg, _, jparams, _ = _pair(name)
        toks, img = _batch(jcfg, 5)
        logits, steps, cache = _jax_run(name)(
            jparams, {"tokens": jnp.asarray(toks),
                      "image_embeds": jnp.asarray(img)})
        _OUTPUTS[name] = (toks, img, _prompt_len(jcfg), np.asarray(logits),
                          np.asarray(steps), jax.tree.map(np.asarray, cache))
    return _OUTPUTS[name]


# ---------------------------------------------------------------- params

@pytest.mark.parametrize("name", ["rest0", "rest1"])
def test_param_spec_matches_the_jax_tree(name):
    """Keys, shapes and dtypes of ``param_spec`` equal the JAX init's
    tree: the self layers stacked (G, every), the cross layers (G,) with
    their two fp32 gates as (G,) leaves, and ``max(rest, 1)`` trailing
    layers (one unused at rest 0)."""
    jcfg, cfg = _cfgs(name, dtype="bfloat16")
    tree = jax.eval_shape(lambda k: jvlm.init(k, jcfg), jax.random.key(0))
    flat = {"/".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    spec = param_spec(cfg)
    assert set(spec) == set(flat)
    for key, (shape, dtype, _) in spec.items():
        assert shape == flat[key].shape, key
        assert str(dtype) == f"torch.{flat[key].dtype.name}", key
    g, rest = cfg.vlm_groups
    assert (g, rest) == ((1, 0) if name == "rest0" else (1, 1))
    assert spec["self_groups/attn/wq"][0][:2] == (g, cfg.cross_attn_every)
    assert spec["cross/gate_attn"][:2] == ((g,), torch.float32)
    assert spec["trailing/mlp/w_gate"][0][0] == max(rest, 1)


def test_init_params_matches_reference_shapes_dtypes_and_scales():
    """llama-vision-smoke in bf16 (its own dtype): shapes and dtypes equal
    the JAX tree's, norms are ones and the gates zeros, the random
    leaves' std within 5% of the reference's (``wo`` and ``w_down`` at
    0.02 / sqrt(2L) in every stack), or within five standard errors on a
    leaf too small for 5%."""
    jcfg, cfg = jax_smoke(ARCH), get_smoke(ARCH)
    flat = _flatten(_jax_init(0, jcfg, gates_open=False))
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
    assert not mine["cross/gate_attn"].any()
    deep = 0.02 / np.sqrt(2 * cfg.num_layers)
    for stack in ("self_groups", "cross", "trailing"):
        assert spec[f"{stack}/mlp/w_down"][2] == pytest.approx(deep)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_bridge_round_trip_is_total_and_exact(dtype, tmp_path):
    """A JAX VLM tree through ``from_numpy`` and through a checkpoint
    (``load_npz``): every leaf, the unused trailing layer and the gates
    included, exact (bf16 bitwise); a missing leaf raises."""
    jcfg, cfg = _cfgs(dtype=dtype)
    jparams = _jax_init(0, jcfg)
    flat = _flatten(jparams)
    port = flatten(from_numpy(flat, cfg, "cpu"))
    assert set(port) == set(flat) == set(param_spec(cfg))
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
    assert port["cross/gate_mlp"].tolist() == [1.0]
    loaded = flatten(load_npz(save_checkpoint(tmp_path, 1, jparams), cfg,
                              "cpu"))
    assert all(torch.equal(loaded[k], port[k]) for k in port)
    flat.pop("trailing/ln1")
    with pytest.raises(KeyError, match="trailing/ln1"):
        from_numpy(flat, cfg, "cpu")


def test_param_count_pins_the_tree_against_the_analytical_count():
    """``ModelConfig.param_count()`` is analytical and differs from the
    tree: it leaves out the trailing layer the tree holds at rest 0, the
    two gates a cross layer and ``final_norm``, and counts 3 d of norms a
    cross layer where the tree has 2 d. Llama-3.2-Vision-90B uncut (20
    groups, rest 0): 88.52 B parameters in the tree; cut to 20 layers (4
    groups) 20.07 B, to 5 layers (one group) 7.24 B, each with its one
    unused trailing layer."""
    def tree(cfg):
        return sum(int(np.prod(s)) for s, _, _ in param_spec(cfg).values())

    full = get_config(ARCH)
    d, f = full.d_model, full.d_ff
    layer = (2 * d * full.q_dim + 2 * d * full.kv_dim + 3 * d * f + 2 * d)
    for layers, want in ((100, 88_522_448_936), (20, 20_070_096_904),
                         (5, 7_235_280_898)):
        cfg = full.with_(num_layers=layers)
        g, rest = cfg.vlm_groups
        assert rest == 0
        assert tree(cfg) == want == \
            cfg.param_count() + layer - g * d + 2 * g + d
    rest1 = full.with_(num_layers=6)     # one group and one trailing layer
    assert tree(rest1) == tree(full.with_(num_layers=5)) \
        == rest1.param_count() + 2


# ----------------------------------------------------------------- model

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_reference(name):
    """Logits within 1e-5 of the reference's, remat on and off (remat
    changes no value); aux is 0; the model maps to the VLM module; a
    batch without images raises ``KeyError`` naming ``image_embeds``."""
    _, cfg, _, params = _pair(name)
    toks, img, _, logits, _, _ = _jax_outputs(name)
    assert get_model(cfg) is vlm
    for remat in (False, True):
        lg, aux = vlm.forward(params, {"tokens": _t(toks),
                                       "image_embeds": _t(img)}, cfg,
                              remat=remat)
        np.testing.assert_allclose(lg.detach().numpy(), logits, atol=1e-5,
                                   rtol=1e-5)
        assert float(aux) == 0.0
    with pytest.raises(KeyError, match="image_embeds"):
        vlm.forward(params, {"tokens": _t(toks)}, cfg)


def test_closed_gates_make_the_images_a_no_op():
    """At init both gates are 0: the logits do not depend on the images
    (bit for bit) and equal the reference's within 1e-5; opened, other
    images give other logits."""
    jcfg, cfg = _cfgs()
    jparams = _jax_init(0, jcfg, gates_open=False)
    params = from_numpy(_flatten(jparams), cfg, "cpu")
    toks, img = _batch(cfg, 6)
    other = np.random.default_rng(7).standard_normal(img.shape).astype(
        np.float32)
    with torch.no_grad():
        a, _ = vlm.forward(params, {"tokens": _t(toks),
                                    "image_embeds": _t(img)}, cfg)
        b, _ = vlm.forward(params, {"tokens": _t(toks),
                                    "image_embeds": _t(other)}, cfg)
        c, _ = vlm.forward(_pair("rest0")[3], {"tokens": _t(toks),
                                                "image_embeds": _t(other)},
                           cfg)
    assert torch.equal(a, b)
    want = _jax_run("rest0")(jparams, {"tokens": jnp.asarray(toks),
                                       "image_embeds": jnp.asarray(img)})[0]
    np.testing.assert_allclose(a.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert (a - c).abs().max() > 1e-3


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_matches_forward_and_reference(name):
    """The reference's ``test_decode_consistency.py`` on the port: a
    prefill of the first p tokens, then 4 decode steps, against the
    teacher-forced forward within 5e-5, and against the reference's own
    prefill + decode within 1e-5 — logits and every cache leaf (``kv_g``,
    ``kv_t``: zero at rest 0, ``xkv``); on the ring (window 16, p = 20)
    too."""
    _, cfg, _, params = _pair(name)
    toks, img, p, logits, steps, jcache = _jax_outputs(name)
    with torch.no_grad():
        cache = vlm.init_cache(cfg, 2, 32, device="cpu")
        lg, cache = vlm.prefill(params, {"tokens": _t(toks[:, :p]),
                                         "image_embeds": _t(img)}, cfg, cache)
        out = [lg]
        for i in range(4):
            lg, cache = vlm.decode_step(params, cache,
                                        _t(toks[:, p + i:p + i + 1]), p + i,
                                        cfg)
            out.append(lg)
    got = torch.cat(out, dim=1).numpy()
    np.testing.assert_allclose(got, steps, atol=1e-5, rtol=1e-5)
    for j, pos in enumerate(range(p - 1, p + 4)):
        err = np.abs(got[:, j] - logits[:, pos]).max()
        assert err < 5e-5, (pos, err)
    for key in ("kv_g", "kv_t", "xkv"):
        for leaf in ("k", "v"):
            assert tuple(cache[key][leaf].shape) == jcache[key][leaf].shape
            np.testing.assert_allclose(cache[key][leaf].numpy(),
                                       jcache[key][leaf], atol=1e-5,
                                       rtol=1e-5, err_msg=f"{key}/{leaf}")
    if cfg.vlm_groups[1] == 0:
        assert not cache["kv_t"]["k"].any()
    assert cache["kv_g"]["k"].shape[2] == (16 if cfg.sliding_window else 32)
    assert int(cache["pos"]) == int(jcache["pos"]) == p + 4


def test_cp_decode_without_a_rank_equals_the_reference():
    """``cp_decode=True`` with no rank current is the ordinary decode, as
    the reference's is where ``cp_available`` is False (no mesh, so its
    decode is the one ``_jax_outputs`` ran): a prefill and four decode
    steps give the reference's logits within 1e-5."""
    _, cfg, _, params = _pair("rest0")
    cfg = cfg.with_(cp_decode=True)
    toks, img, p, _, steps, _ = _jax_outputs("rest0")
    with torch.no_grad():
        cache = vlm.init_cache(cfg, 2, 32, device="cpu")
        lg, cache = vlm.prefill(params, {"tokens": _t(toks[:, :p]),
                                         "image_embeds": _t(img)}, cfg, cache)
        out = [lg]
        for i in range(4):
            lg, cache = vlm.decode_step(params, cache,
                                        _t(toks[:, p + i:p + i + 1]), p + i,
                                        cfg)
            out.append(lg)
    np.testing.assert_allclose(torch.cat(out, dim=1).numpy(), steps,
                               atol=1e-5, rtol=1e-5)


# -------------------------------------------------------------- training

_TRAIN = {}
OPTIMIZERS = ("adamw", "adafactor")


def _jax_train(optimizer):
    """The reference's train step on the rest-1 config in float32 with
    remat and 2 microbatches (4 x 32 tokens, 4 image blocks) under each of
    ``OPTIMIZERS`` — one jit for both, made once — and the gradient the
    step applied, the microbatches' mean: AdamW's first moment after its
    first step is (1 - b1) x that gradient clipped by the reference's
    ``clip_by_global_norm`` (a factor min(1, 1 / (grad_norm + 1e-9))),
    so it is read back from the step's own state."""
    if not _TRAIN:
        jcfg, cfg, jparams, _ = _pair("rest1")
        toks, img = _batch(cfg, 8, b=4)
        strats = [JaxStrategy(remat=True, microbatches=2, attn_impl="auto",
                              optimizer=o, dtype="float32")
                  for o in OPTIMIZERS]

        @jax.jit
        def steps(p, b):
            return [jstep.make_train_step(jcfg, st, lr=3e-4)(
                p, jstep.init_opt_state(p, st), b) for st in strats]

        out = steps(jparams, {"tokens": jnp.asarray(toks),
                              "image_embeds": jnp.asarray(img)})
        f32 = np.float32
        gnorm = f32(out[0][2]["grad_norm"])
        clip = np.minimum(f32(1.0), f32(1.0) / (gnorm + f32(1e-9)))
        grad = {k: m / f32(1 - 0.9) / clip
                for k, m in _flatten(out[0][1]["m"]).items()}
        for o, (new_p, _, metrics) in zip(OPTIMIZERS, out):
            _TRAIN[o] = (toks, img, grad, _flatten(new_p),
                         {k: float(v) for k, v in metrics.items()})
    return _TRAIN[optimizer]


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_train_step_matches_reference(optimizer):
    """remat on (each group checkpointed whole), 2 microbatches (each
    slicing tokens and images): the microbatches' mean loss gradient
    within 1e-5 of the one the reference's step applied (the trailing
    layer's and the gates' too); one step's loss and grad norm within
    1e-5 (relative), and its params within 1e-5 where that gradient
    exceeds 2e-6 (AdamW's first update is g / (|g| + 1e-8): where the two
    microbatches cancel to ~1e-8, float32 summation order alone moves
    it)."""
    jcfg, cfg, jparams, _ = _pair("rest1")
    toks, img, jgrad, jnew, jmetrics = _jax_train(optimizer)
    strat = Strategy(remat=True, microbatches=2, attn_impl="auto",
                     optimizer=optimizer, dtype="float32")
    params = from_numpy(_flatten(jparams), cfg, "cpu")
    leaves = flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)
    loss_fn = step.make_loss_fn(cfg, strat)
    mean = None
    for i in (0, 2):
        total, _ = loss_fn(params, {"tokens": _t(toks[i:i + 2]),
                                    "image_embeds": _t(img[i:i + 2])})
        grads = [g / 2 for g in torch.autograd.grad(total,
                                                   list(leaves.values()))]
        mean = grads if mean is None else [a + b for a, b in zip(mean, grads)]
    for key, g in zip(leaves, mean):
        np.testing.assert_allclose(g.numpy(), jgrad[key], atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    assert np.abs(jgrad["cross/gate_attn"]).max() > 0
    new, _, metrics = step.make_train_step(cfg, strat, lr=3e-4)(
        params, step.init_opt_state(params, strat),
        {"tokens": _t(toks), "image_embeds": _t(img)})
    for k in ("loss", "grad_norm"):
        assert float(metrics[k]) == pytest.approx(jmetrics[k], rel=1e-5,
                                                  abs=1e-5), k
    live_any = 0
    for key, p in flatten(new).items():
        live = np.abs(jgrad[key]) > 2e-6
        live_any += int(live.sum())
        np.testing.assert_allclose(p.detach().numpy()[live],
                                   jnew[key][live], atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    assert live_any > 0


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_unused_trailing_layer_gets_zero_gradients(optimizer):
    """At rest 0 the loss never reaches the trailing layer: the train
    step gives it zero gradients (as ``jax.grad`` does), so Adafactor
    leaves it as it was and AdamW only decays it (by lr x weight decay
    0.1, as the reference's step updates it too)."""
    jcfg, cfg, jparams, _ = _pair("rest0")
    params = from_numpy(_flatten(jparams), cfg, "cpu")
    before = flatten(params)["trailing/attn/wq"].clone()
    strat = Strategy(remat=True, optimizer=optimizer, dtype="float32")
    toks, img = _batch(cfg, 9, b=2, s=16)
    new, _, metrics = step.make_train_step(cfg, strat, lr=1e-3)(
        params, step.init_opt_state(params, strat),
        {"tokens": _t(toks), "image_embeds": _t(img)})
    assert np.isfinite(float(metrics["loss"]))
    after = flatten(new)["trailing/attn/wq"]
    if optimizer == "adafactor":
        assert torch.equal(after, before)
    else:
        torch.testing.assert_close(after, before * (1 - 1e-3 * 0.1),
                                   atol=1e-9, rtol=1e-6)


def test_session_trains_on_images_and_refuses_token_only_data(tmp_path):
    """``Session.train`` on ``ImagesData``: two steps with finite losses
    that move the cross layers and the gates, a checkpoint, and a resume
    bit for bit. Without images the first step raises ``KeyError`` naming
    ``image_embeds`` in the model's forward, where the reference's
    fails."""
    _, cfg = _cfgs()
    strat = Strategy(remat=True, dtype="float32")
    tc = TrainConfig(steps=2, lr=1e-3, log_every=1, checkpoint_every=2,
                     checkpoint_dir=str(tmp_path))
    data = ImagesData(cfg, global_batch=2, seq_len=16, seed=3)
    assert data.batch(0)["image_embeds"].shape == (
        2, cfg.num_image_tokens, cfg.d_model)
    session = Session(cfg, strategy=strat, device="cpu", seed=3)
    init = {k: v.detach().clone() for k, v in flatten(session.params).items()}
    hist = session.train(tc, data=data).run()["history"]
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    trained = flatten(session.params)
    for key in ("cross/xattn/wk", "cross/gate_attn", "cross/gate_mlp",
                "self_groups/mlp/w_up"):
        assert not torch.equal(trained[key], init[key]), key
    other = Session(cfg, strategy=strat, device="cpu", seed=9)
    resumed = other.train(tc, data=data, restore=True)
    assert resumed.step == 2
    for key, p in flatten(other.params).items():
        assert torch.equal(p, trained[key]), key
    bare = Session(cfg, strategy=strat, device="cpu").train(global_batch=2,
                                                            seq_len=16)
    with pytest.raises(KeyError, match="image_embeds"):
        bare.run(1)


def test_train_launcher_runs_vlm_on_cpu(capsys):
    from repro_torch.launch import train as launcher
    out = launcher.main(["--device", "cpu", "--arch", ARCH, "--steps", "2",
                         "--global-batch", "2", "--seq", "16",
                         "--optimizer", "adafactor"])
    assert out["history"][-1]["step"] == 2
    assert np.isfinite(out["history"][-1]["loss"])
    assert "tokens/s on cpu" in capsys.readouterr().out


def test_trainer_checks_flash_limits_for_vlm():
    """On a CUDA device (no card needed to refuse) the VLM's flash limits
    are checked before any parameter is made; Llama-3.2-Vision-90B's
    heads (64/8 x 128) pass."""
    odd = get_smoke(ARCH).with_(head_dim=20)
    with pytest.raises(ValueError, match="flash-attention kernel"):
        check_kernel_limits(odd, Strategy(), "cuda")
    with pytest.raises(ValueError, match="flash-attention kernel"):
        Session(odd, device="cuda").train()
    check_kernel_limits(odd, Strategy(), "cpu")
    check_kernel_limits(get_config(ARCH), Strategy(), "cuda")


# ------------------------------------------------- tests/test_smoke_archs.py

def _smoke_batch(cfg, seed, b=2, s=32):
    toks, img = _batch(cfg, seed, b, s)
    return {"tokens": _t(toks), "image_embeds": _t(img)}


def test_smoke_forward_shapes_and_finite():
    """``test_forward_shapes_and_finite[llama-3.2-vision-90b]``: the smoke
    config in its own dtype (bf16), random weights, logits (2, 32, V)
    finite."""
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
    """``test_one_train_step[llama-3.2-vision-90b]``: remat, 2
    microbatches, bf16 — finite loss and grad norm, and the params
    change."""
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
    """``test_decode_step_shapes[llama-3.2-vision-90b]``: one decode step
    at position 0 on a fresh 64-token cache, logits (2, 1, V) finite."""
    cfg = get_smoke(ARCH)
    params = init_params(cfg, device="cpu", seed=2)
    cache = vlm.init_cache(cfg, 2, 64, device="cpu")
    g, rest = cfg.vlm_groups
    assert cache["xkv"]["k"].shape == (g, 2, cfg.num_image_tokens,
                                       cfg.num_kv_heads, cfg.head_dim)
    assert cache["kv_g"]["k"].shape[0] == g * cfg.cross_attn_every
    assert cache["kv_t"]["k"].shape[0] == max(rest, 1)
    with torch.no_grad():
        logits, _ = vlm.decode_step(params, cache,
                                    torch.zeros((2, 1), dtype=torch.int32),
                                    0, cfg)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
