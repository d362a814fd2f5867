"""The port's training path against the JAX package (repro_torch/{train,
optim,data,checkpoint,core} and the attention dispatch of
models/layers.py).

Inputs come from numpy with a seed; the JAX side initialises the params
and the weight bridge carries them over. Tolerances: layers and the
train step at 1e-5 (fp32, another summation order), optimizer updates at
1e-6. After an AdamW step params are compared only where the reference's
gradient exceeds 1e-6: the first update is about ``lr * sign(g)``, and
near-zero gradients may flip sign between frameworks.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.strategy import Strategy as JaxStrategy  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.train import losses as jlosses  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import checkpoint as tio  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.strategy import Strategy  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.train import losses, step  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer  # noqa: E402
from repro_torch.tree import flatten, unflatten  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _smoke_pair(seed=0):
    """(port cfg, JAX cfg, JAX params) for qwen3-smoke in float32."""
    jcfg = jax_smoke("qwen3-14b").with_(dtype="float32")
    cfg = ModelConfig(**jcfg.__dict__)
    return cfg, jcfg, get_model(jcfg).init(jax.random.key(seed), jcfg)


# -------------------------------------------------- attention dispatch

ATTN = {  # name -> (attention kwargs, S = T)
    "masked": (dict(impl="masked"), 128),
    "chunked_window": (dict(impl="chunked", window=40), 128),
    "triangle": (dict(impl="triangle"), 128),
    "triangle_not_square": (dict(impl="triangle", causal=False), 128),
    "auto": (dict(impl="auto"), 96),
    "full_window": (dict(impl="full", window=17), 96),
    "pallas": (dict(impl="pallas"), 128),
}


@pytest.mark.parametrize("name", sorted(ATTN))
def test_attention_dispatch_matches_reference(name):
    kw, s = ATTN[name]
    kw = dict(dict(causal=True, q_chunk=32, kv_chunk=32), **kw)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, s, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 2, 16)).astype(np.float32)
    before = fa.flash_attention.launches
    got = layers.attention(_t(q), _t(k), _t(v), **kw)
    want = jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert fa.flash_attention.launches == before      # CPU: no kernel


@pytest.mark.parametrize("impl", ["masked", "triangle"])
def test_attention_chunked_matches_reference(impl):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 64, 4, 8)).astype(np.float32)
    k = rng.standard_normal((1, 64, 4, 8)).astype(np.float32)
    v = rng.standard_normal((1, 64, 4, 8)).astype(np.float32)
    got = layers.attention_chunked(_t(q), _t(k), _t(v), causal=True,
                                   q_chunk=16, kv_chunk=16, impl=impl)
    want = jl.attention_chunked(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, q_chunk=16,
                                kv_chunk=16, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        layers.attention_chunked(_t(q)[:, :60], _t(k), _t(v), causal=True,
                                 q_chunk=16, kv_chunk=16)


# ------------------------------------------------------------- losses

def test_cross_entropy_and_accuracy_with_ignored_labels():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(3, 7)).astype(np.int32)
    labels[0, 2:] = -1
    labels[2, -1] = -1
    labels[1, 3] = int(np.argmax(logits[1, 3]))
    for fn, jfn in ((losses.cross_entropy, jlosses.cross_entropy),
                    (losses.token_accuracy, jlosses.token_accuracy)):
        got = float(fn(_t(logits), _t(labels)))
        want = float(jfn(jnp.asarray(logits), jnp.asarray(labels)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
    # every label ignored: 0, not NaN
    assert float(losses.cross_entropy(_t(logits), _t(np.full_like(
        labels, -1)))) == 0.0


# --------------------------------------------------------- optimizers

SHAPES = {"w": (6, 5), "stack/w": (3, 4, 6), "b": (7,), "thin": (1, 9)}


def _opt_tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _jtree(flat):
    return unflatten({k: jnp.asarray(v) for k, v in flat.items()})


def _ttree(flat):
    return unflatten({k: _t(v) for k, v in flat.items()})


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(3)
    p, g = _opt_tree(rng), _opt_tree(rng, 0.1)
    m, v = _opt_tree(rng, 0.01), {k: np.abs(a) for k, a in
                                  _opt_tree(rng, 0.001).items()}
    state = {"m": m, "v": v, "master": p}
    jstate = {k: _jtree(t) for k, t in state.items()}
    jstate["step"] = jnp.asarray(3, jnp.int32)
    want_p, want_s = jopt.adamw_update(_jtree(g), jstate, _jtree(p), lr=1e-2)
    tstate = {k: _ttree(t) for k, t in state.items()}
    tstate["step"] = torch.tensor(3, dtype=torch.int32)
    got_p, got_s = topt.adamw_update(_ttree(g), tstate, _ttree(p), lr=1e-2)
    assert int(got_s["step"]) == 4
    for tree, jtree in ((got_p, want_p), (got_s["m"], want_s["m"]),
                        (got_s["v"], want_s["v"]),
                        (got_s["master"], want_s["master"])):
        for k, a in flatten(tree).items():
            np.testing.assert_allclose(a.numpy(), np.asarray(
                flatten(jtree)[k]), atol=1e-6, rtol=1e-6, err_msg=k)


def test_adamw_init_copies_and_keeps_bf16_params_in_their_dtype():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16),
         "s": torch.ones((4,))}
    st = topt.adamw_init(p)
    assert st["master"]["w"].dtype == torch.float32
    assert st["master"]["s"].data_ptr() != p["s"].data_ptr()
    g = {"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16),
         "s": torch.full((4,), 0.5)}
    topt.adamw_update(g, st, p, lr=0.1)
    assert p["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"].float(), st["master"]["w"].to(torch.bfloat16)
                       .float())


def test_adafactor_update_matches_reference():
    rng = np.random.default_rng(4)
    p, g = _opt_tree(rng), _opt_tree(rng, 0.1)
    jp = _jtree(p)
    jstate = jopt.adafactor_init(jp)
    tstate = topt.adafactor_init(_ttree(p))
    for k, a in flatten(tstate["vr"]).items():
        assert tuple(a.shape) == flatten(jstate["vr"])[k].shape, k
    for k, a in flatten(tstate["vc"]).items():
        assert tuple(a.shape) == flatten(jstate["vc"])[k].shape, k
    tp = _ttree(p)
    for _ in range(2):                     # second step: nonzero vr/vc
        jp, jstate = jopt.adafactor_update(_jtree(g), jstate, jp, lr=1e-2,
                                           weight_decay=0.01)
        tp, tstate = topt.adafactor_update(_ttree(g), tstate, tp, lr=1e-2,
                                           weight_decay=0.01)
    for tree, jtree in ((tp, jp), (tstate["vr"], jstate["vr"]),
                        (tstate["vc"], jstate["vc"])):
        for k, a in flatten(tree).items():
            np.testing.assert_allclose(a.numpy(), np.asarray(
                flatten(jtree)[k]), atol=1e-6, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _opt_tree(np.random.default_rng(5))
    want, wn = jopt.clip_by_global_norm(_jtree(g), max_norm)
    got, gn = topt.clip_by_global_norm(_ttree(g), max_norm)
    assert float(gn) == pytest.approx(float(wn), rel=1e-6)
    for k, a in flatten(got).items():
        np.testing.assert_allclose(a.numpy(), np.asarray(flatten(want)[k]),
                                   atol=1e-6, rtol=1e-6)


def test_cosine_lr_matches_reference():
    for s in (0, 3, 10, 11, 57, 100, 140):
        got = float(topt.cosine_lr(s, base_lr=3e-4, warmup=10, total=100))
        want = float(jopt.cosine_lr(s, base_lr=3e-4, warmup=10, total=100))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s


# ------------------------------------------------------- data pipeline

@pytest.mark.parametrize("kind", ["synthetic", "file"])
def test_token_dataset_batches_equal_reference(kind, tmp_path):
    kw = dict(vocab_size=97, seq_len=40, global_batch=3, seed=5, kind=kind)
    if kind == "file":
        path = tmp_path / "corpus.bin"
        np.random.default_rng(6).integers(0, 97, size=5000).astype(
            np.uint32).tofile(path)
        kw["path"] = str(path)
    mine = tdata.TokenDataset(tdata.DataConfig(**kw))
    ref = jdata.TokenDataset(jdata.DataConfig(**kw))
    for stp in (0, 1, 7):
        a, b = mine.batch(stp), ref.batch(stp)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    # shard_batch places a data rank's rows: its contiguous share of
    # every microbatch where the batch splits over "data", else all rows
    # (the reference's batch_shardings drops a sharding that does not
    # divide)
    rows = np.arange(8)
    got = [tdata.shard_batch({"t": rows}, 2, i, microbatches=2)["t"]
           for i in range(2)]
    assert [g.tolist() for g in got] == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert tdata.shard_batch(a, 2, 1)["tokens"].tolist() == \
        a["tokens"].tolist()                       # 3 rows: whole
    assert not tdata.rows_split(8, 2, microbatches=8)
    assert tdata.rows_split(8, 4) and not tdata.rows_split(8, 1)
    half = tdata.shard_batch({k: torch.from_numpy(v) for k, v in
                              mine.batch(0).items()}, 3, 2)
    np.testing.assert_array_equal(half["labels"].numpy(),
                                  mine.batch(0)["labels"][2:])


# --------------------------------------------------------- checkpoints

def test_checkpoints_restore_across_packages_bit_for_bit(tmp_path):
    jcfg = jax_smoke("qwen3-14b")                        # bfloat16
    cfg = ModelConfig(**jcfg.__dict__)
    jparams = get_model(jcfg).init(jax.random.key(1), jcfg)
    jflat = jio._flatten(jparams)
    # JAX writes, the port restores
    jio.save_checkpoint(tmp_path / "jax", 5, jparams)
    like = from_numpy(jflat, cfg, "cpu")
    like = {k: torch.zeros_like(v) for k, v in flatten(like).items()}
    assert tio.latest_step(tmp_path / "jax") == 5
    got = flatten(tio.load_checkpoint(tmp_path / "jax", 5, unflatten(like)))
    for key, arr in jflat.items():
        assert got[key].dtype == getattr(torch, arr.dtype.name), key
        np.testing.assert_array_equal(
            got[key].view(torch.int16).numpy() if arr.dtype.itemsize == 2
            else got[key].numpy(),
            arr.view(np.int16) if arr.dtype.itemsize == 2 else arr,
            err_msg=key)
    # the port writes, JAX restores: same bytes, same manifest
    tio.save_checkpoint(tmp_path / "torch", 5, unflatten(got))
    back = jio._flatten(jio.load_checkpoint(tmp_path / "torch", 5, jparams))
    for key, arr in jflat.items():
        assert np.asarray(back[key]).tobytes() == arr.tobytes(), key
    manifests = [json.loads((tmp_path / d / "step_00000005" /
                             "manifest.json").read_text())
                 for d in ("jax", "torch")]
    assert manifests[0] == manifests[1]


# ---------------------------------------------------------- train step

@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step (attn_impl="pallas", the kernel in interpret
    mode) on qwen3-smoke in float32, with its loss gradients."""
    cfg, jcfg, jparams = _smoke_pair()
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
    strat = JaxStrategy(attn_impl="pallas", dtype="float32")
    batch = {"tokens": jnp.asarray(tokens)}
    _, grads = jax.value_and_grad(jstep.make_loss_fn(jcfg, strat),
                                  has_aux=True)(jparams, batch)
    new_p, _, metrics = jax.jit(jstep.make_train_step(jcfg, strat, lr=3e-4))(
        jparams, jstep.init_opt_state(jparams, strat), batch)
    return (cfg, tokens, jio._flatten(jparams), jio._flatten(grads),
            jio._flatten(new_p), {k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_matches_reference(jax_step, remat):
    cfg, tokens, jflat, jgrads, jnew, jmetrics = jax_step
    strat = Strategy(remat=remat, attn_impl="pallas", dtype="float32")
    params = from_numpy(jflat, cfg, "cpu")
    leaves = flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)
    total, _ = step.make_loss_fn(cfg, strat)(params,
                                             {"tokens": _t(tokens)})
    grads = torch.autograd.grad(total, list(leaves.values()))
    for key, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[key], atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    train_step = step.make_train_step(cfg, strat, lr=3e-4)
    new, _, metrics = train_step(params, step.init_opt_state(params, strat),
                                 {"tokens": _t(tokens)})
    assert float(metrics["loss"]) == pytest.approx(jmetrics["loss"],
                                                   rel=1e-5, abs=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(
        jmetrics["grad_norm"], rel=1e-5, abs=1e-5)
    for key, p in flatten(new).items():
        live = np.abs(jgrads[key]) > 1e-6
        np.testing.assert_allclose(p.detach().numpy()[live], jnew[key][live],
                                   atol=1e-5, rtol=1e-5, err_msg=key)


def test_microbatched_step_equals_one_batch():
    """Two microbatches with fp32 accumulation give the one-batch step:
    equal token counts per microbatch make the mean of means the mean."""
    cfg, _, jparams = _smoke_pair(seed=2)
    flat = jio._flatten(jparams)
    tokens = _t(np.random.default_rng(8).integers(
        0, cfg.vocab_size, size=(4, 32)).astype(np.int32))
    out = {}
    for n in (1, 2):
        strat = Strategy(remat=False, microbatches=n, attn_impl="full",
                         dtype="float32")
        params = from_numpy(flat, cfg, "cpu")
        new, _, m = step.make_train_step(cfg, strat)(
            params, step.init_opt_state(params, strat), {"tokens": tokens})
        out[n] = (flatten(new), {k: float(v) for k, v in m.items()})
    assert out[2][1]["loss"] == pytest.approx(out[1][1]["loss"], rel=1e-6)
    assert out[2][1]["grad_norm"] == pytest.approx(out[1][1]["grad_norm"],
                                                   rel=1e-5)
    for key, p in out[1][0].items():
        np.testing.assert_allclose(out[2][0][key].detach().numpy(),
                                   p.detach().numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        strat = Strategy(microbatches=3, dtype="float32")
        step.make_train_step(cfg, strat)(
            params, step.init_opt_state(params, strat), {"tokens": tokens})


def test_strategy_keeps_the_single_device_knobs():
    """The training knobs; ``rules`` is the sharding table (held to the
    reference's in tests/test_torch_sharding.py), and ``seq_parallel`` /
    ``fsdp``, like ``zero1``, shape that table and train on a mesh
    (tests/test_torch_train_parallel.py): a one-device trainer accepts
    them and steps as it would without them."""
    s = Strategy()
    assert (s.optimizer, s.remat, s.microbatches, s.attn_impl, s.zero1) == \
        ("adamw", True, 1, "auto", True)
    assert s.with_(remat=False).remat is False
    assert s.rules({"data": 2, "model": 4})["d_ff"] == "model"
    cfg = ModelConfig(**jax_smoke("qwen3-14b").__dict__).with_(
        dtype="float32", num_layers=1)
    runs = []
    for kw in ({}, dict(seq_parallel=True), dict(fsdp=True)):
        trainer = Trainer(cfg, Strategy(dtype="float32", remat=False, **kw),
                          "cpu", TrainConfig(steps=1, log_every=1),
                          global_batch=2, seq_len=8)
        assert trainer.rank is None
        runs.append((trainer.run()["history"][0]["loss"],
                     flatten(trainer.params)))
    for loss, params in runs[1:]:
        assert loss == runs[0][0]
        for key, p in params.items():
            assert torch.equal(p, runs[0][1][key]), key


# ------------------------------------------------- Trainer and Session

def test_session_trains_checkpoints_and_restores(tmp_path):
    cfg = _smoke_pair()[0].with_(num_layers=1)
    strat = Strategy(remat=False, dtype="float32")
    tc = TrainConfig(steps=2, lr=1e-3, log_every=1, checkpoint_every=2,
                     checkpoint_dir=str(tmp_path))
    session = Session(cfg, strategy=strat, device="cpu", seed=3)
    init = {k: v.detach().clone() for k, v in flatten(session.params).items()}
    trainer = session.train(tc, global_batch=2, seq_len=16)
    hist = trainer.run()["history"]
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    trained = flatten(session.params)
    assert any(not torch.equal(trained[k], init[k]) for k in init)
    assert tio.latest_step(tmp_path) == 2
    # a fresh session (other seed) resumes at step 2 with those params,
    # and AdamW's master is rebuilt from them
    other = Session(cfg, strategy=strat, device="cpu", seed=9)
    resumed = other.train(tc, global_batch=2, seq_len=16, restore=True)
    assert resumed.step == 2
    restored = flatten(resumed.params)
    for key, p in flatten(other.params).items():
        assert p is restored[key], key       # restored into the same tree
        assert torch.equal(p, trained[key]), key
        assert torch.equal(flatten(resumed.opt_state["master"])[key], p)
    # serving takes detached views of the trained params
    eng = other.serve(slots=1, max_len=32, chunk_tokens=8)
    assert not eng.params["embed"].requires_grad


def test_train_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import train as launcher
    out = launcher.main(["--device", "cpu", "--steps", "2",
                         "--global-batch", "2", "--seq", "16",
                         "--layers", "1"])
    assert len(out["history"]) == 1 and out["history"][0]["step"] == 2
    assert "tokens/s on cpu" in capsys.readouterr().out


# ------------------------------------------------ the SSM family, the hybrid

#: the families the train step dispatches to beside dense: arch -> the
#: reference's smoke config in float32 (zamba2-smoke: one group, rest 0,
#: so one unused trailing layer whose gradient is zero in both packages)
FAMILIES = ("mamba2-780m", "zamba2-1.2b")
_FAMILY_STEPS = {}


def _jax_family_step(arch):
    """One JAX train step on the arch's smoke config in float32 (remat
    off: it changes no value; the reference's plain attention, where the
    family has one: ``test_train_step_matches_reference`` holds the
    port's flash forward and backward to the Pallas kernel in interpret
    mode), with its loss gradients; made once an arch."""
    if arch not in _FAMILY_STEPS:
        jcfg = jax_smoke(arch).with_(dtype="float32")
        cfg = ModelConfig(**jcfg.__dict__)
        jparams = jax.jit(get_model(jcfg).init, static_argnums=1)(
            jax.random.key(4), jcfg)
        tokens = np.random.default_rng(9).integers(
            0, cfg.vocab_size, size=(2, 64)).astype(np.int32)
        strat = JaxStrategy(remat=False, attn_impl="auto", dtype="float32")
        loss_fn = jstep.make_loss_fn(jcfg, strat)
        train_step = jstep.make_train_step(jcfg, strat, lr=3e-4)

        @jax.jit        # the gradients and one AdamW step, one compile
        def grads_and_step(p, batch):
            _, g = jax.value_and_grad(loss_fn, has_aux=True)(p, batch)
            return (g,) + train_step(p, jstep.init_opt_state(p, strat),
                                     batch)

        grads, new_p, _, metrics = grads_and_step(
            jparams, {"tokens": jnp.asarray(tokens)})
        _FAMILY_STEPS[arch] = (
            cfg, tokens, jio._flatten(jparams), jio._flatten(grads),
            jio._flatten(new_p), {k: float(v) for k, v in metrics.items()})
    return _FAMILY_STEPS[arch]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_train_step_matches_reference(arch, remat):
    """mamba2-smoke and zamba2-smoke, 2 x 64 tokens (two SSD chunks), the
    port's remat off and on (per layer / per group ``checkpoint``): its
    loss gradients within 1e-5 of ``jax.value_and_grad``'s, and
    one AdamW step (``make_train_step``) within 1e-5 (params where the
    reference's gradient exceeds 1e-6), its loss and grad norm within
    rel 1e-5."""
    cfg, tokens, jflat, jgrads, jnew, jmetrics = _jax_family_step(arch)
    strat = Strategy(remat=remat, attn_impl="pallas", dtype="float32")
    params = from_numpy(jflat, cfg, "cpu")
    leaves = flatten(params)
    for p in leaves.values():
        p.requires_grad_(True)
    total, _ = step.make_loss_fn(cfg, strat)(params, {"tokens": _t(tokens)})
    grads = torch.autograd.grad(total, list(leaves.values()),
                                materialize_grads=True)
    for key, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[key], atol=1e-5,
                                   rtol=1e-5, err_msg=key)
    train_step = step.make_train_step(cfg, strat, lr=3e-4)
    new, _, metrics = train_step(params, step.init_opt_state(params, strat),
                                 {"tokens": _t(tokens)})
    assert float(metrics["loss"]) == pytest.approx(jmetrics["loss"],
                                                   rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(
        jmetrics["grad_norm"], rel=1e-5)
    for key, p in flatten(new).items():
        live = np.abs(jgrads[key]) > 1e-6
        np.testing.assert_allclose(p.detach().numpy()[live], jnew[key][live],
                                   atol=1e-5, rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("arch", FAMILIES)
def test_session_trains_each_family_checkpoints_and_restores(arch, tmp_path):
    """``Session.train`` on the CPU for the SSM family and the hybrid: two
    steps with finite losses that move the params, a checkpoint, and a
    fresh session that resumes from it bit for bit."""
    cfg = ModelConfig(**jax_smoke(arch).with_(dtype="float32").__dict__)
    strat = Strategy(remat=True, dtype="float32")
    tc = TrainConfig(steps=2, lr=1e-3, log_every=1, checkpoint_every=2,
                     checkpoint_dir=str(tmp_path))
    session = Session(cfg, strategy=strat, device="cpu", seed=3)
    init = {k: v.detach().clone() for k, v in flatten(session.params).items()}
    hist = session.train(tc, global_batch=2, seq_len=32).run()["history"]
    assert [h["step"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    trained = flatten(session.params)
    assert any(not torch.equal(trained[k], init[k]) for k in init)
    other = Session(cfg, strategy=strat, device="cpu", seed=9)
    resumed = other.train(tc, global_batch=2, seq_len=32, restore=True)
    assert resumed.step == 2
    for key, p in flatten(other.params).items():
        assert torch.equal(p, trained[key]), key


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_launcher_runs_each_family_on_cpu(arch, capsys):
    from repro_torch.launch import train as launcher
    out = launcher.main(["--device", "cpu", "--arch", arch, "--steps", "2",
                         "--global-batch", "2", "--seq", "64"])
    assert out["history"][-1]["step"] == 2
    assert np.isfinite(out["history"][-1]["loss"])
    assert "tokens/s on cpu" in capsys.readouterr().out


def test_trainer_checks_flash_limits_by_family():
    """On a CUDA device (no card needed to refuse) the trainer checks the
    flash kernel's limits where attention runs — dense layers and the
    hybrid's shared block — and never for the SSM family, which has no
    heads (num_heads 0 would read "Hq (0) a multiple of Hkv (0)")."""
    from repro_torch.train.trainer import check_kernel_limits
    from repro_torch.configs import get_smoke
    ssm = get_smoke("mamba2-780m")
    assert ssm.num_heads == 0
    check_kernel_limits(ssm, Strategy(), "cuda")
    odd = get_smoke("zamba2-1.2b").with_(head_dim=20)      # bf16, D 20
    with pytest.raises(ValueError, match="flash-attention kernel"):
        check_kernel_limits(odd, Strategy(), "cuda")
    check_kernel_limits(odd, Strategy(), "cpu")
    check_kernel_limits(get_smoke("zamba2-1.2b"), Strategy(), "cuda")
