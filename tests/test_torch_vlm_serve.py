"""The port's engine serving the VLM against the JAX engine: ``images=``
requests on the split path over the dense per-slot layout, the only
layout the reference serves the family on (repro_torch/serve/engine.py
over models/vlm.py).

Each run is held to the JAX engine's on the same config, seed, prompts
and images: the same greedy streams and the same counters (``prefills``,
``decode_tokens``, ``decode_steps``, ``decode_traces``,
``prefill_traces``). Each JAX engine run is made once (``_jax_run``) and
shared. The config is the reference tests' ``VLM_CFG``
(tests/test_serve_vlm.py: 3 layers = one group of 2 self layers and a
cross layer, d 64, 4/2 heads, 8 image tokens, float32) at seed 0, with
both gates of the cross layer open, as that test opens them.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.core.strategy import Strategy as JaxStrategy  # noqa: E402
from repro.models import get_model as jax_model  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro.serve.step import greedy_generate as jax_generate  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.params import from_numpy, init_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

KW = dict(name="serve-vlm", arch_type="vlm", num_layers=3, d_model=64,
          num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
          cross_attn_every=2, num_image_tokens=8, dtype="float32")
DENSE_KW = dict(name="serve-vlm-dense", arch_type="dense", num_layers=2,
                d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                vocab_size=128, dtype="float32")

COUNTERS = ("prefills", "decode_tokens", "decode_steps",
            "decode_slot_steps", "decode_traces", "prefill_traces",
            "preemptions")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes are tiny: one intra-op thread computes them as fast,
    and the test workers running beside this one keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(rng, n):
    return [rng.standard_normal((8, 64)).astype(np.float32)
            for _ in range(n)]


def _greedy_traffic():
    """tests/test_serve_vlm.py:57's traffic: prompts of 5, 9 and 7 tokens,
    then one image block each, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, size=(int(n),)).astype(np.int32)
               for n in (5, 9, 7)]
    return prompts, _images(rng, len(prompts))


def _images_traffic():
    """tests/test_serve_vlm.py:78's traffic: one prompt under images a, b,
    a."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, 128, size=(6,)).astype(np.int32)
    im_a, im_b = _images(rng, 2)
    return [prompt] * 3, [im_a, im_b, im_a]


#: run -> (traffic, max_new, engine keywords): the reference tests'
#: settings (file:line in each test's docstring)
RUNS = {"greedy": (_greedy_traffic(), 6, dict(slots=1, max_len=32)),
        "images": (_images_traffic(), 8, dict(slots=2, max_len=32))}

_JAX_PARAMS = []
_JAX_RUNS = {}


def _jax_params():
    """The reference's init of VLM_CFG at seed 0, jitted once, gates
    open."""
    if not _JAX_PARAMS:
        jcfg = JaxConfig(**KW)
        p = jax.jit(jax_model(jcfg).init, static_argnums=1)(
            jax.random.key(0), jcfg)
        p["cross"]["gate_attn"] = jnp.ones_like(p["cross"]["gate_attn"])
        p["cross"]["gate_mlp"] = jnp.ones_like(p["cross"]["gate_mlp"])
        _JAX_PARAMS.append(p)
    return _JAX_PARAMS[0]


def _submit_all(eng, name):
    (prompts, images), new, _ = RUNS[name]
    for i, (p, im) in enumerate(zip(prompts, images)):
        eng.submit(i, p, max_new=new, images=im)


def _preempt_once(eng):
    """Step until a slot holds a request with 2+ tokens, then preempt it.
    Returns the slot."""
    while not any(r is not None and len(r.out) >= 2 for r in eng.active):
        eng.step()
    slot = next(s for s, r in enumerate(eng.active)
                if r is not None and len(r.out) >= 2)
    eng.preempt(slot)
    return slot


def _jax_run(name, preempt=False):
    """(streams, stats, engine) of the JAX engine on run ``name`` (with
    one preemption mid-run when ``preempt``), made once."""
    key = (name, preempt)
    if key not in _JAX_RUNS:
        eng = JaxEngine(JaxConfig(**KW), _jax_params(), **RUNS[name][2])
        _submit_all(eng, name)
        slot = _preempt_once(eng) if preempt else None
        res = eng.run()
        _JAX_RUNS[key] = ({i: list(res[i].out) for i in res},
                          dict(eng.stats), eng, slot)
    return _JAX_RUNS[key]


def _port_run(name, params, preempt=False):
    eng = ServeEngine(ModelConfig(**KW), params, **RUNS[name][2])
    _submit_all(eng, name)
    slot = _preempt_once(eng) if preempt else None
    res = eng.run()
    assert all(r.done for r in res.values())
    return {i: list(res[i].out) for i in res}, eng, slot


def _same_counters(eng, jstats):
    for key in COUNTERS:
        assert eng.stats[key] == jstats[key], key


@pytest.fixture(scope="module")
def params():
    return from_numpy(_flatten(_jax_params()), ModelConfig(**KW), "cpu")


def _reference_greedy(prompt, images, new, max_len=32):
    """tests/test_serve_vlm.py's B=1 prefill + decode_step loop in JAX —
    the reference's exactness oracle."""
    jcfg = JaxConfig(**KW)
    mod = jax_model(jcfg)
    params = _jax_params()
    cache = mod.init_cache(jcfg, 1, max_len)
    batch = {"tokens": jnp.asarray(prompt, jnp.int32)[None],
             "image_embeds": jnp.asarray(images, jnp.float32)[None]}
    logits, cache = mod.prefill(params, batch, jcfg, cache)
    out = [int(jnp.argmax(logits[0, -1]))]
    step = jax.jit(lambda p, c, t, i: mod.decode_step(p, c, t, i, jcfg))
    while len(out) < new:
        logits, cache = step(params, cache, jnp.asarray([[out[-1]]],
                                                        jnp.int32),
                             jnp.asarray(len(prompt) + len(out) - 1,
                                         jnp.int32))
        out.append(int(jnp.argmax(logits[0, -1])))
    return out


def test_engine_matches_jax_engine_and_reference_greedy(params):
    """tests/test_serve_vlm.py:57: one slot, so the decode batch is the
    reference loop's (1, 1) — the port's streams equal the JAX engine's
    and the hand-rolled greedy loop's, with its counters; the layout
    resolves to dense rows and the split path, unbucketed, one prefill
    shape a distinct prompt length and one decode shape."""
    want, jstats, _, _ = _jax_run("greedy")
    got, eng, _ = _port_run("greedy", params)
    assert not eng.paged and not eng.mixed and not eng._bucketed
    assert got == want
    (prompts, images), new, _ = RUNS["greedy"]
    assert got[0] == _reference_greedy(prompts[0], images[0], new)
    _same_counters(eng, jstats)
    assert eng.stats["prefill_traces"] == 3
    assert eng.stats["decode_traces"] == 1


def test_images_distinguish_requests_as_jax(params):
    """tests/test_serve_vlm.py:78: the same prompt under images a, b, a on
    2 slots — the cross layers see each request's own images (not a
    stale or shared block): streams 0 and 2 equal, 0 and 1 differ, all
    equal to the JAX engine's, with its counters."""
    want, jstats, _, _ = _jax_run("images")
    got, eng, _ = _port_run("images", params)
    assert got == want
    assert got[0] == got[2] != got[1]
    _same_counters(eng, jstats)


def test_preempt_mid_run_matches_jax(params):
    """``preempt()`` on 2 slots once a request holds 2 tokens, on both
    engines: the victim re-prefills prompt + out with its own images and
    resumes; streams equal the JAX engine's under the same call and the
    uninterrupted run's, with every counter."""
    want, jstats, _, jslot = _jax_run("images", preempt=True)
    got, eng, slot = _port_run("images", params, preempt=True)
    assert slot == jslot
    assert got == want == _jax_run("images")[0]
    _same_counters(eng, jstats)
    assert eng.stats["preemptions"] == 1
    assert eng.stats["prefills"] == 4


def test_images_validation_matches_the_reference(params):
    """tests/test_serve_vlm.py:97: a VLM request without images, or with
    images of another shape, raises the reference's ``ValueError`` with
    its text; images on a dense engine raise naming ``vlm``, frames on a
    VLM engine naming ``audio``, each as the reference's; the stored
    images are float32."""
    jeng = JaxEngine(JaxConfig(**KW), _jax_params(), slots=1, max_len=32)
    eng = ServeEngine(ModelConfig(**KW), params, slots=1, max_len=32)
    # submit() refuses before any weight is read: the dense JAX engine
    # holds the VLM's tree
    jdense = JaxEngine(JaxConfig(**DENSE_KW), _jax_params(), slots=1,
                       max_len=32)
    dense = ServeEngine(ModelConfig(**DENSE_KW),
                        init_params(ModelConfig(**DENSE_KW), device="cpu"),
                        slots=1, max_len=32)
    prompt = np.arange(4, dtype=np.int32)
    for (je, te), kw, match in (
            ((jeng, eng), dict(), "images"),
            ((jeng, eng), dict(images=np.zeros((3, 64), np.float32)),
             "shape"),
            ((jeng, eng), dict(images=np.zeros((8, 64), np.float32),
                               frames=np.zeros((8, 64), np.float32)),
             "audio"),
            ((jdense, dense), dict(images=np.zeros((8, 64), np.float32)),
             "vlm")):
        with pytest.raises(ValueError, match=match) as want:
            je.submit(0, prompt, max_new=2, **kw)
        with pytest.raises(ValueError, match=match) as got:
            te.submit(0, prompt, max_new=2, **kw)
        assert str(got.value) == str(want.value)
    req = eng.submit(1, prompt, max_new=2,
                     images=np.zeros((8, 64), np.float64))
    assert req.images.dtype == np.float32


@pytest.mark.parametrize("kw", [dict(paged=True), dict(mixed=True),
                                dict(prefix_cache=True), dict(lazy=True)])
def test_layout_rules_refuse_like_the_reference(params, kw):
    """The VLM is not pageable: the paged pool, the mixed step, the prefix
    cache and lazy growth raise the reference's ``ValueError`` with its
    text."""
    with pytest.raises(ValueError) as want:
        JaxEngine(JaxConfig(**KW), _jax_params(), slots=1, max_len=32, **kw)
    with pytest.raises(ValueError) as got:
        ServeEngine(ModelConfig(**KW), params, slots=1, max_len=32, **kw)
    assert str(got.value) == str(want.value)


def test_decode_state_counts_self_and_image_kv_as_jax(params):
    """The resident decode state: the self K/V rows of every self layer
    (``kv_g``, and ``kv_t``: one unused layer at rest 0) and the image
    K/V block of every cross layer (``xkv``), in bytes equal to the JAX
    engine's."""
    _, _, jeng, _ = _jax_run("images")
    eng = ServeEngine(ModelConfig(**KW), params, slots=2, max_len=32)
    c = eng._cache
    assert c["kv_g"]["k"].shape == (2, 2, 32, 2, 16)
    assert c["kv_t"]["k"].shape == (1, 2, 32, 2, 16)
    assert c["xkv"]["k"].shape == (1, 2, 8, 2, 16)
    assert eng.kv_bytes() == jeng.kv_bytes() == 2 * 4 * (
        3 * 2 * 32 * 2 * 16 + 2 * 8 * 2 * 16)


def test_session_generates_with_image_embeds_and_serves_async(params):
    """``Session.generate`` on a batch dict with ``image_embeds`` gives
    the reference's ``greedy_generate``; ``Session.serve`` resolves to
    the split path on dense rows; ``serve_async(start=False)`` forwards
    each request's images and streams the JAX engine's tokens."""
    cfg = ModelConfig(**KW)
    session = Session(cfg, device="cpu", params=params)
    (prompts, images), new, kw = RUNS["images"]
    toks = np.stack([prompts[0], prompts[1]])
    img = np.stack([images[0], images[1]])
    want = jax_generate(_jax_params(), JaxConfig(**KW),
                        JaxStrategy(dtype="float32"),
                        {"tokens": jnp.asarray(toks),
                         "image_embeds": jnp.asarray(img)}, new)
    got = session.generate({"tokens": toks, "image_embeds": img}, steps=new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    eng = session.serve(**kw)
    assert not eng.paged and not eng.mixed and "xkv" in eng._cache
    driver = session.serve_async(start=False, **kw)
    streams = [driver.submit(p, max_new=new, rid=i, images=im)
               for i, (p, im) in enumerate(zip(prompts, images))]
    driver.start()
    out = {s.rid: s.tokens() for s in streams}
    driver.stop(drain=True, timeout=60)
    assert out == _jax_run("images")[0]


def test_vlm_kernel_checks_on_a_cuda_device(params):
    """On a CUDA device (no card needed to refuse) a VLM engine checks
    flash for its split prefills and the fused MLP for every program;
    Llama-3.2-Vision-90B's heads (64/8 x 128) and widths (d 8192, f
    28672) pass."""
    bad_heads = ModelConfig(**dict(KW, dtype="bfloat16", head_dim=20))
    with pytest.raises(ValueError, match="flash-attention kernel"):
        ServeEngine(bad_heads, params, device="cuda")
    odd_ff = ModelConfig(**dict(KW, dtype="bfloat16", d_ff=20))
    with pytest.raises(ValueError, match="fused-MLP kernel"):
        ServeEngine(odd_ff, params, device="cuda")
    full = get_config("llama-3.2-vision-90b")
    eng = SimpleNamespace(cfg=full, paged=False, mixed=False, page_size=16,
                          spec=None, device="cuda")
    ServeEngine._check_kernel_limits(eng)


def test_serve_launcher_runs_vlm_on_cpu(capsys):
    """``launch/serve.py --arch llama-3.2-vision-90b`` on its smoke config
    in float32, each request with seeded images: the split path on dense
    rows; every request done with its tokens."""
    from repro_torch.launch import serve as launcher
    results = launcher.main(["--arch", "llama-3.2-vision-90b", "--device",
                             "cpu", "--requests", "3", "--max-new", "4",
                             "--trace-level", "0"])
    assert len(results) == 3
    assert all(r.done and len(r.out) == 4 and r.images is not None
               for r in results.values())
    text = capsys.readouterr().out
    assert "plain path" in text and "dense slot table, split" in text
