"""Tensor-parallel serving in the port, on CPU gloo ranks: the twin of
tests/test_serve_parallel.py's tp cases (dense, expert-parallel MoE,
enc-dec) and of tests/test_tp_collectives.py.

The reference shards one GSPMD program over conftest's 8 host devices;
the port runs one process a rank (serve/engine.py with ``mesh=``,
core/tp.py). One spawn starts two ranks (``launch/ranks.py``: a
``spawn`` context, a FileStore rendezvous under ``tmp_path``, one thread
a rank, a timeout that kills the ranks) which import ``repro_torch``
only, take numpy params from this process and run every case. The tp 2
streams are held to the JAX engine's tp 1 streams on the same weights
(the reference's own tests pin its tp 2 = tp 1), its counters to the JAX
engine's, its logits to the JAX ``decode_step``'s within
tests/test_torch_decode.py's ``LOGITS_TOL`` (the MoE config's within the
ROADMAP's parity bar, 1e-5). With one KV head (``KW_KV1``) the split
path's dense rows and SWA ring hold each rank's sequence slice (the
reference's ``cache_pspecs``) and decode context-parallel. The
context-parallel lockstep decode (models/cp_attention.py) of
tests/test_cp_attention.py's Qwen3 smoke config runs on the same spawn:
its logits against JAX's CP ``decode_step`` under a (1, 2) mesh and the
JAX full forward, its collective bytes against one cache, and
``greedy_generate`` under the rank against JAX's streams
(tests/test_torch_parallel.py runs the (1, 4) and (2, 2) meshes). The
online driver and HTTP server over the two ranks (serve/driver.py's
control channel) run on the same spawn on tests/test_serve_online.py's
config, prompts and ``max_new``: deferred start, live submission, a
deadline that expires while queued, a watchdog requeue after a stall on
rank 0, ``stop(drain=False)``, ``/generate`` / ``/metrics`` /
``/healthz`` on rank 0, and ranks fed different batches; their streams
are held to the JAX engine's batch ``run()``. The
MoE config (``MOE_KW``: E 4 over tp 2,
two experts a rank; the same with TP inside each expert,
``Strategy(expert_parallel=False)``: all four experts and half of each
expert's d_ff a rank, one (T, d) ``moe_out`` sum a layer, 1/k of the
expert-parallel bytes, held to the same JAX runs; and ``MOE_E3_KW``: E 3,
which the table keeps whole on both ranks) and the enc-dec config
(``AUDIO_KW``, frames with each request) are the reference's
``MOE_CFG`` and ``AUDIO_CFG`` (tests/test_serve_parallel.py:23-31) at
its seeds. The SSM family
(tests/test_serve_engine.py's ``SSM_CFG`` at its seed) and the hybrid
(the zamba2 smoke in f32) serve on the same spawn, a Mamba2 block split by
whole heads: the JAX engine's streams and counters, one ``ssm_out`` and
one ``ssm_norm`` sum a Mamba layer a program, half the states a rank;
and the reference's ``test_decode_sharded_equals_reference`` runs on
(1, 2) for both smokes (``ssm_model_rank``: ``decode_step`` from a zero
cache and after a prefill within its 5e-4, the prefill's states the JAX
states of the rank's heads and its conv tails JAX's ``[x_r | B | C]``
channels). The VLM (tests/test_serve_vlm.py's ``VLM_CFG``, its gates
opened to 1.0 as that test does, seeded images with each request) serves
on the same spawn: the JAX engine's unsharded streams and counters, two
sums a self and a cross layer; with one KV head its self rows and image
K/V hold each rank's sequence slice, decoded context-parallel; its
lockstep ``cp_decode`` against JAX's CP ``decode_step`` under a (1, 2)
mesh; and ``Session.serve(tp=2)`` of the VLM smoke with images against
``serve()``. A planner Plan runs on the same spawn: ``Plan.materialize``'s
checks and layouts on two ranks, and ``Session.from_plan`` of the "dp"
search's 2-chip plan (dp 1 x tp 2 with ``seq_parallel``: the reference's
plan on H100's fields) whose ``serve()`` gives the streams of JAX's
``Session.from_plan(..., devices=2).serve()``, mixed and split; an
engine under ``fsdp`` and ``seq_parallel`` serves the Megatron layout,
the streams of one without them. Each JAX run is made once and shared.

This module imports JAX and the reference only inside functions: the
ranks import it by name to find their entry points.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.core.strategy import Strategy  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

LOGITS_TOL = 1e-4               # tests/test_torch_decode.py's
MOE_LOGITS_TOL = 1e-5           # the ROADMAP's parity bar in f32
RANK_TIMEOUT = 120.0            # seconds a spawn may take before it fails

#: tests/test_serve_parallel.py's CFG, and the same with one KV head (the
#: pool replicated on both ranks: 1 does not divide tp 2)
KW = dict(name="par-dense", arch_type="dense", num_layers=2, d_model=128,
          num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=128,
          dtype="float32")
KW_KV1 = dict(KW, name="par-dense-kv1", num_kv_heads=1)
KW_RING = dict(KW, name="par-dense-swa", sliding_window=8)
KW_KV1_RING = dict(KW_KV1, name="par-dense-kv1-swa", sliding_window=8)
#: tests/test_serve_parallel.py's MOE_CFG and AUDIO_CFG, and MOE_CFG with 3
#: experts (3 does not divide tp 2: every rank keeps all three)
MOE_KW = dict(name="par-moe", arch_type="moe", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, num_experts=4,
              experts_per_token=2, vocab_size=128, dtype="float32")
MOE_E3_KW = dict(MOE_KW, name="par-moe-e3", num_experts=3)
AUDIO_KW = dict(name="par-encdec", arch_type="audio", num_layers=2,
                d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
                vocab_size=128, encoder_layers=1, encoder_ctx=12,
                dtype="float32")
#: AUDIO_CFG with one KV head: at tp 2 its dense rows and cross K/V hold
#: each rank's sequence slice (the reference's ``cache_pspecs``)
AUDIO_KV1_KW = dict(AUDIO_KW, name="par-encdec-kv1", num_kv_heads=1)
#: tests/test_serve_engine.py's SSM_CFG, and the hybrid's smoke in f32
SSM_KW = dict(name="engine-ssm", arch_type="ssm", num_layers=2, d_model=64,
              num_heads=0, num_kv_heads=0, d_ff=128, ssm_state=16,
              ssm_heads=4, ssm_head_dim=16, vocab_size=128, dtype="float32")
ZAMBA_KW = dict(get_smoke("zamba2-1.2b").with_(dtype="float32").__dict__)
#: the hybrid with one KV head: at tp 2 its dense rows hold each rank's
#: sequence slice (the reference's ``cache_pspecs``), decoded
#: context-parallel
ZAMBA_KV1_KW = dict(ZAMBA_KW, name="zamba2-smoke-kv1", num_kv_heads=1)
#: tests/test_serve_vlm.py's VLM_CFG (3 layers: 2 self and 1 cross, the
#: unused trailing layer; 8 image tokens; its gates opened to 1.0 as that
#: test does), and the same with one KV head: at tp 2 its self rows and
#: its image K/V hold each rank's sequence slice
VLM_KW = dict(name="serve-vlm", arch_type="vlm", num_layers=3, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
              cross_attn_every=2, num_image_tokens=8, dtype="float32")
VLM_KV1_KW = dict(VLM_KW, name="serve-vlm-kv1", num_kv_heads=1)
#: each config's init seed (the reference tests' own)
SEEDS = {"par-moe": 5, "par-moe-e3": 5, "par-encdec": 2,
         "par-encdec-kv1": 2, "engine-ssm": 4,
         "zamba2-smoke": 4, "zamba2-smoke-kv1": 4}

COUNTERS = ("prefills", "decode_tokens", "decode_steps", "peak_pages",
            "decode_traces", "prefill_traces", "prefix_hit_blocks",
            "prefix_miss_blocks", "prefix_tail_hits", "prefix_evictions",
            "prefix_decode_blocks", "preemptions", "cow_copies",
            "spec_drafted", "spec_accepted")


def _prompts(seed, lens, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32)
            for n in lens]


def _shared_prefix():
    """tests/test_serve_parallel.py:381's prompts: a 16-token system
    prompt and 5 tokens each."""
    rng = np.random.default_rng(4)
    sys_p = rng.integers(0, 128, size=(16,))
    return [np.concatenate([sys_p, rng.integers(0, 128, size=(5,))])
            .astype(np.int32) for _ in range(4)]


def _repeats():
    """p, p, q, p (tests/test_serve_prefix.py:81): a repeat of an
    unaligned prompt takes a partial tail page, copied on write."""
    rng = np.random.default_rng(6)
    p = rng.integers(0, 128, size=(11,)).astype(np.int32)
    q = rng.integers(0, 128, size=(9,)).astype(np.int32)
    return [p, p, q, p]


def _motifs():
    """tests/test_serve_spec.py:172's prompts: two random, two tiled
    motifs (the ngram drafter's proposals get accepted)."""
    rng = np.random.default_rng(5)
    out = [rng.integers(0, 128, size=(n,)).astype(np.int32) for n in (5, 19)]
    for _ in range(2):
        motif = rng.integers(0, 128, size=(int(rng.integers(3, 6)),))
        out.append(np.tile(motif, int(rng.integers(4, 7))).astype(np.int32))
    return out


#: run -> (config, prompts, max_new, engine keywords; ``spec`` the draft
#: length k): (a) the reference's tp 2 run, (b) the split path on the pool
#: and dense rows and the SWA ring, (c) the prefix cache with lazy
#: growth, as the reference's and on a pool below demand (preemption,
#: CoW), and speculative decode, (e) one KV head: the pool replicated,
#: the dense rows and the ring sequence-sharded
RUNS = {
    "mixed": (KW, _prompts(0, (5, 7, 6, 8, 5)), 6,
              dict(slots=2, max_len=64, paged=True)),
    "split_pool": (KW, _prompts(0, (5, 7, 6, 8, 5)), 6,
                   dict(slots=2, max_len=64, paged=True, mixed=False)),
    "split_dense": (KW, _prompts(0, (5, 7, 6, 8, 5)), 6,
                    dict(slots=2, max_len=64, paged=False)),
    "ring": (KW_RING, _prompts(1, (5, 7, 6, 8, 5)), 6,
             dict(slots=2, max_len=64)),
    "prefix": (KW, _shared_prefix(), 6,
               dict(slots=2, max_len=64, paged=True, prefix_cache=True,
                    lazy=True)),
    "prefix_dry": (KW, _repeats(), 6,
                   dict(slots=2, max_len=64, paged=True, page_size=4,
                        kv_pages=6, chunk_tokens=16, prefix_cache=True,
                        lazy=True)),
    "spec": (KW, _motifs(), 6,
             dict(slots=2, max_len=64, paged=True, chunk_tokens=16,
                  spec=4)),
    "kv1": (KW_KV1, _prompts(2, (5, 7, 6, 8)), 6,
            dict(slots=2, max_len=64, paged=True, chunk_tokens=16)),
    "split_dense_kv1": (KW_KV1, _prompts(2, (5, 7, 6, 8)), 6,
                        dict(slots=2, max_len=64, paged=False)),
    "ring_kv1": (KW_KV1_RING, _prompts(1, (5, 7, 6, 8, 5)), 6,
                 dict(slots=2, max_len=64)),
}

#: tests/test_cp_attention.py's case: the Qwen3 smoke config (Hkv 2) in
#: f32 with ``cp_decode``, B 4, S 32 (a 28-token prefill, four decode
#: steps); its collective-volume case at B 8, S 64; the tolerance of its
#: logits against the full forward
CP_B, CP_S, CP_PROMPT = 4, 32, 28
#: and a 14-token prompt: at tp 2 rank 1's 16 positions are all masked
#: for two steps, then the cursor lands on the first of them
CP_SHORT = 14
CP_VOL_B, CP_VOL_S = 8, 64
CP_TOL = 5e-4
CP_TOKS = np.random.default_rng(26).integers(0, 512, size=(CP_B, CP_S)) \
    .astype(np.int32)
CP_VOL_TOKS = np.random.default_rng(27).integers(
    0, 512, size=(CP_VOL_B, CP_VOL_S)).astype(np.int32)


def _audio_requests():
    """tests/test_serve_parallel.py:97's prompts, then each one's frames,
    from one generator."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, size=(n,)).astype(np.int32)
               for n in (4, 7, 5)]
    frames = [rng.standard_normal((AUDIO_KW["encoder_ctx"],
                                   AUDIO_KW["d_model"])).astype(np.float32)
              for _ in prompts]
    return prompts, frames


_AUDIO = _audio_requests()


def _vlm_requests():
    """Three prompts, then each one's (8, 64) image embeddings, from one
    generator."""
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, 128, size=(n,)).astype(np.int32)
               for n in (5, 9, 6)]
    images = [rng.standard_normal((VLM_KW["num_image_tokens"],
                                   VLM_KW["d_model"])).astype(np.float32)
              for _ in prompts]
    return prompts, images


_VLM = _vlm_requests()


def _media(kw, media, i: int) -> dict:
    """Request ``i``'s keyword of ``media``: an enc-dec request's
    ``frames``, a VLM request's ``images`` (none: nothing)."""
    if media is None:
        return {}
    return {"images" if kw["arch_type"] == "vlm" else "frames": media[i]}

#: TP inside each expert: every expert on every rank, d_ff over "model"
TIE = Strategy(dtype="float32", expert_parallel=False)

#: run -> (config, prompts, frames / images or None, max_new, engine
#: keywords): the reference's MoE tp 2 case (one slot, 8-token pages) on
#: the mixed step and the split path, with the experts over "model" and
#: with TP inside each expert (``TIE``), two slots with the prefix cache
#: and lazy growth, the experts kept whole (E 3); the reference's enc-dec
#: tp 2 case on the mixed step and the split path; the VLM on the split path's
#: dense rows (its only layout), with Hkv 2 and Hkv 1
FAMILY_RUNS = {
    "moe_mixed": (MOE_KW, _prompts(6, (5, 8, 6)), None, 4,
                  dict(slots=1, max_len=32, paged=True, page_size=8)),
    "moe_split": (MOE_KW, _prompts(6, (5, 8, 6)), None, 4,
                  dict(slots=1, max_len=32, paged=True, page_size=8,
                       mixed=False)),
    "moe_tie_mixed": (MOE_KW, _prompts(6, (5, 8, 6)), None, 4,
                      dict(slots=1, max_len=32, paged=True, page_size=8,
                           strategy=TIE)),
    "moe_tie_split": (MOE_KW, _prompts(6, (5, 8, 6)), None, 4,
                      dict(slots=1, max_len=32, paged=True, page_size=8,
                           mixed=False, strategy=TIE)),
    "moe_prefix": (MOE_KW, _repeats(), None, 4,
                   dict(slots=2, max_len=32, paged=True, page_size=4,
                        prefix_cache=True, lazy=True)),
    "moe_e3": (MOE_E3_KW, _prompts(6, (5, 8, 6)), None, 4,
               dict(slots=1, max_len=32, paged=True, page_size=8)),
    "audio_mixed": (AUDIO_KW, _AUDIO[0], _AUDIO[1], 5,
                    dict(slots=2, max_len=32, paged=True)),
    "audio_split": (AUDIO_KW, _AUDIO[0], _AUDIO[1], 5,
                    dict(slots=2, max_len=32, paged=True, mixed=False)),
    # one KV head on the split path's dense rows: each rank holds half of
    # the decoder's and the encoder's positions with the one head
    "audio_kv1_dense": (AUDIO_KV1_KW, _AUDIO[0], _AUDIO[1], 5,
                        dict(slots=2, max_len=32, paged=False,
                             mixed=False)),
    # tests/test_serve_engine.py::test_engine_ssm_matches_sequential's
    # run, and the hybrid smoke's on the same engine keywords
    "ssm": (SSM_KW, _prompts(4, (5, 9, 6)), None, 5,
            dict(slots=2, max_len=64)),
    "hybrid": (ZAMBA_KW, _prompts(9, (5, 9, 6), vocab=512), None, 5,
               dict(slots=2, max_len=64)),
    "hybrid_kv1": (ZAMBA_KV1_KW, _prompts(9, (5, 9, 6), vocab=512), None,
                   5, dict(slots=2, max_len=64)),
    "vlm": (VLM_KW, _VLM[0], _VLM[1], 5, dict(slots=2, max_len=32)),
    "vlm_kv1": (VLM_KV1_KW, _VLM[0], _VLM[1], 5, dict(slots=2, max_len=32)),
}


def _spec_kw(ekw, spec_cls):
    return dict(ekw, spec=spec_cls(k=ekw["spec"])) if "spec" in ekw else ekw

_JAX = {}


def _weights(kw):
    """The name of the config whose weights ``kw`` takes: a ring's are
    its full-attention config's (a sliding window changes no shape)."""
    return {KW_RING["name"]: KW["name"],
            KW_KV1_RING["name"]: KW_KV1["name"]}.get(kw["name"], kw["name"])


def _jax_params(kw):
    """(the reference's config of ``kw``, its init at seed 0 — a VLM's
    with both gates opened to 1.0 — that init flattened to numpy with the
    bridge's keys); each init made once."""
    from repro.configs.base import ModelConfig as JaxConfig
    key = ("params", _weights(kw))
    if key not in _JAX:
        import jax
        from repro.checkpoint.io import _flatten
        from repro.models import get_model
        jcfg = JaxConfig(**kw)
        jparams = jax.jit(get_model(jcfg).init, static_argnums=1)(
            jax.random.key(SEEDS.get(kw["name"], 0)), jcfg)
        if jcfg.arch_type == "vlm":
            # the gates init to 0 (the images move nothing): open them
            for gate in ("gate_attn", "gate_mlp"):
                jparams["cross"][gate] = jax.numpy.ones_like(
                    jparams["cross"][gate])
        _JAX[key] = (jparams, {k: np.asarray(v)
                               for k, v in _flatten(jparams).items()})
    return (JaxConfig(**kw),) + _JAX[key]


def _flat(kw):
    return _jax_params(kw)[2]


def _jax_run(name):
    """(streams, stats, kv_bytes, per-device kv bytes) of the JAX engine,
    unsharded, on run ``name``, made once."""
    if name not in _JAX:
        from repro.serve.engine import ServeEngine as JaxEngine
        from repro.serve.speculative import SpecConfig as JaxSpec
        kw, prompts, new, ekw = RUNS[name]
        jcfg, jparams, _ = _jax_params(kw)
        eng = JaxEngine(jcfg, jparams, **_spec_kw(ekw, JaxSpec))
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=new)
        res = eng.run()
        _JAX[name] = ({i: list(res[i].out) for i in res}, dict(eng.stats),
                      eng.kv_bytes(), eng.per_device_kv_bytes())
    return _JAX[name]


#: a run whose JAX reference is another run's: the unsharded engine does
#: not depend on how a mesh would split the experts
JAX_TWIN = {"moe_tie_mixed": "moe_mixed", "moe_tie_split": "moe_split"}


def _jax_family_run(name):
    """(streams, stats, per-device kv bytes) of the JAX engine, unsharded,
    on ``FAMILY_RUNS[name]`` (its ``JAX_TWIN``'s), made once."""
    name = JAX_TWIN.get(name, name)
    if name not in _JAX:
        from repro.serve.engine import ServeEngine as JaxEngine
        kw, prompts, media, new, ekw = FAMILY_RUNS[name]
        jcfg, jparams, _ = _jax_params(kw)
        eng = JaxEngine(jcfg, jparams, **ekw)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=new, **_media(kw, media, i))
        res = eng.run()
        _JAX[name] = ({i: list(res[i].out) for i in res}, dict(eng.stats),
                      eng.per_device_kv_bytes())
    return _JAX[name]


#: tests/test_serve_online.py's CFG and engine keywords, and its cases
#: run through the online driver over the ranks: run -> (prompts,
#: max_new) of the JAX batch each is held to ("deadline": the third
#: prompt expires while queued, so the batch is of the first two;
#: "stop": the streams cut short are prefixes of it)
ONLINE_KW = dict(name="online-dense", arch_type="dense", num_layers=2,
                 d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                 vocab_size=128, dtype="float32")
ONLINE_ENG = dict(slots=2, max_len=64, paged=True)
ONLINE_RUNS = {"deferred": (_prompts(1, (5, 7, 6, 8, 5)), 6),
               "live": (_prompts(3, (5, 7, 6)), 5),
               "deadline": (_prompts(4, (5, 7, 6)), 6),
               "watchdog": (_prompts(7, (6,)), 8),
               "stop": (_prompts(11, (5, 6)), 40),
               "http": (_prompts(8, (5, 7)), 6),
               # tests/test_serve_online.py::test_stream_matches_run_dp2's,
               # served by the dp 2 x tp 2 router (test_torch_parallel.py)
               "router": (_prompts(2, (5, 7, 6, 8, 5, 4)), 6)}


def jax_online(name):
    """The JAX engine's batch ``run()`` streams of ``ONLINE_RUNS[name]``
    (the deadline run's first two prompts), made once."""
    key = ("online", name)
    if key not in _JAX:
        from repro.serve.engine import ServeEngine as JaxEngine
        prompts, new = ONLINE_RUNS[name]
        if name == "deadline":
            prompts = prompts[:2]
        jcfg, jparams, _ = _jax_params(ONLINE_KW)
        eng = JaxEngine(jcfg, jparams, **ONLINE_ENG)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=new)
        res = eng.run()
        _JAX[key] = {i: list(res[i].out) for i in res}
    return _JAX[key]


def _cp_cfg(jax=False):
    """The CP case's config: the port's, or the reference's."""
    if jax:
        from repro.configs import get_smoke
    else:
        from repro_torch.configs import get_smoke
    return get_smoke("qwen3-14b").with_(dtype="float32", cp_decode=True)


def _jax_cp_params():
    """(the reference's CP config, its init at key 0, flattened to numpy),
    made once."""
    if "cp_params" not in _JAX:
        import jax
        from repro.checkpoint.io import _flatten
        from repro.models import get_model
        jcfg = _cp_cfg(jax=True)
        jp = jax.jit(get_model(jcfg).init, static_argnums=1)(
            jax.random.key(0), jcfg)
        _JAX["cp_params"] = (jcfg, jp, {k: np.asarray(v) for k, v in
                                        _flatten(jp).items()})
    return _JAX["cp_params"]


def jax_cp(mesh_shape, prompt=CP_PROMPT):
    """(JAX's CP ``decode_step`` logits of the steps after ``prompt``
    tokens under a ``mesh_shape`` ("data", "model") mesh, the cache laid
    out by its ``cache_pspecs``; JAX's full-forward logits), made once a
    (mesh, prompt): the steps of tests/test_cp_attention.py on
    ``CP_TOKS``."""
    key = ("cp", tuple(mesh_shape), prompt)
    if key not in _JAX:
        import jax
        import jax.numpy as jnp
        from repro.core import sharding as shd
        from repro.core.pspec import sharding_rules
        from repro.core.strategy import Strategy as JaxStrategy
        from repro.launch.mesh import make_mesh as jax_mesh
        from repro.models import get_model
        jcfg, jp, _ = _jax_cp_params()
        mod = get_model(jcfg)
        toks = jnp.asarray(CP_TOKS)
        full, _ = mod.forward(jp, {"tokens": toks}, jcfg)
        _, cache0 = mod.prefill(jp, {"tokens": toks[:, :prompt]}, jcfg,
                                mod.init_cache(jcfg, CP_B, CP_S))
        mesh = jax_mesh(tuple(mesh_shape), ("data", "model"))
        st = JaxStrategy(remat=False, dtype="float32")

        def named(specs):
            return jax.tree.map(lambda sp: jax.NamedSharding(mesh, sp),
                                specs)

        logits = []
        with sharding_rules(mesh, st.rules(mesh)):
            # the cache starts as cache_pspecs lays it out and keeps the
            # layout the CP step returns (the sequence, over "model")
            step = jax.jit(
                lambda p, c, t, i: mod.decode_step(p, c, t, i, jcfg),
                in_shardings=(named(shd.param_pspecs(jp, st, mesh)), None,
                              None, None))
            c = jax.device_put(cache0, named(
                shd.cache_pspecs(cache0, st, mesh, CP_B)))
            for pos in range(prompt, CP_S):
                lg, c = step(jp, c, toks[:, pos:pos + 1],
                             jnp.asarray(pos, jnp.int32))
                logits.append(np.asarray(lg))
        _JAX[key] = (logits, np.asarray(full))
    return _JAX[key]


def check_cp_rank(got, mesh_shape):
    """One rank's CP decode (``cp_rank``) against JAX's CP decode under
    the same mesh (LOGITS_TOL) and the JAX full forward (CP_TOL), on the
    rank's data row; its cache holding S / tp positions, every K/V
    head."""
    want, full = jax_cp(mesh_shape, got["prompt"])
    dp, model = mesh_shape
    b = CP_B // dp
    rows = slice(got["row"] * b, (got["row"] + 1) * b)
    for i, pos in enumerate(range(got["prompt"], CP_S)):
        np.testing.assert_allclose(got["logits"][i], want[i][rows],
                                   atol=LOGITS_TOL, rtol=0, err_msg=str(pos))
        np.testing.assert_allclose(got["logits"][i][:, 0], full[rows, pos],
                                   atol=CP_TOL, rtol=0, err_msg=str(pos))
    assert got["positions"] == CP_S // model
    assert got["slice"] == (got["model_rank"] * CP_S // model, CP_S // model)
    assert got["heads"] == _cp_cfg().num_kv_heads
    assert got["available"]


def cp_rank(mesh_shape, flat, prompt=CP_PROMPT):
    """The lockstep CP decode on a ``mesh_shape`` ("data", "model") CPU
    mesh: the rank's shards (``from_numpy(shard=)``), its data row's B /
    dp rows of ``CP_TOKS``, a ``prompt``-token prefill and a decode step
    a remaining position under ``tp.active``; each step's logits, what
    the rank's cache holds and ``cp_available`` after the steps."""
    toks = CP_TOKS
    from repro_torch.models import transformer
    from repro_torch.models.cp_attention import cp_available
    cfg = _cp_cfg()
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"),
                     device_type="cpu")
    params = from_numpy(flat, cfg, "cpu",
                        shard=(Strategy(dtype=cfg.dtype), mesh))
    view = tp.Rank.of(mesh, cfg)
    row = tp.coordinate(mesh)["data"]
    b = toks.shape[0] // mesh_shape[0]
    t = torch.from_numpy(toks[row * b:(row + 1) * b])
    logits = []
    with tp.active(view):
        cache = transformer.init_cache(cfg, b, CP_S)
        transformer.prefill(params, {"tokens": t[:, :prompt]}, cfg, cache)
        for pos in range(prompt, CP_S):
            got, cache = transformer.decode_step(
                params, cache, t[:, pos:pos + 1], pos, cfg)
            logits.append(got.numpy())
        available = cp_available(cfg, cache, CP_S - 1)
    sl = cache["kv_slice"]
    return {"row": row, "model_rank": view.rank, "prompt": prompt,
            "logits": logits,
            "positions": cache["kv"]["k"].shape[2],
            "heads": cache["kv"]["k"].shape[3],
            "slice": (sl.start, sl.length), "available": available}


def _cp_extra_rank(world, flat):
    """(b) the collective volume of one CP decode step at B 8, S 64 (a
    60-token prefill), by label, bytes and counts; (c) ``greedy_generate``
    under the rank on ``CP_TOKS``'s prompts; both on a (1, world)
    mesh."""
    from repro_torch.models import transformer
    from repro_torch.serve.step import greedy_generate
    cfg = _cp_cfg()
    mesh = _mesh(world)
    strategy = Strategy(dtype=cfg.dtype)
    params = from_numpy(flat, cfg, "cpu", shard=(strategy, mesh))
    view = tp.Rank.of(mesh, cfg)
    t = torch.from_numpy(CP_VOL_TOKS)
    with tp.active(view):
        cache = transformer.init_cache(cfg, CP_VOL_B, CP_VOL_S)
        transformer.prefill(params, {"tokens": t[:, :-4]}, cfg, cache)
        prefill = (dict(view.counts), dict(view.bytes))
        view.counts.clear()
        view.bytes.clear()
        transformer.decode_step(params, cache, t[:, -4:-3], CP_VOL_S - 4,
                                cfg)
        step = (dict(view.counts), dict(view.bytes))
        view.counts.clear()
        streams = greedy_generate(
            params, cfg, strategy,
            {"tokens": torch.from_numpy(CP_TOKS[:, :CP_PROMPT])},
            CP_S - CP_PROMPT)
    return {"prefill": prefill, "step": step,
            "greedy": streams.numpy(), "greedy_counts": dict(view.counts)}


# ------------------------------------------------ the VLM's CP decode, lockstep

#: the VLM's lockstep case: ``VLM_KW`` with ``cp_decode``, B 2, a cache of
#: S 16 (8 positions a rank at tp 2), a 12-token prefill with each row's
#: images, then four decode steps at a scalar ``pos``; its logits within
#: the ROADMAP's parity bar of JAX's CP ``decode_step``
VLM_CP_B, VLM_CP_S, VLM_CP_PROMPT = 2, 16, 12
VLM_CP_TOL = 1e-5
VLM_CP_TOKS = np.random.default_rng(14).integers(
    0, 128, size=(VLM_CP_B, VLM_CP_S)).astype(np.int32)
VLM_CP_IMAGES = np.random.default_rng(15).standard_normal(
    (VLM_CP_B, VLM_KW["num_image_tokens"], VLM_KW["d_model"])).astype(
    np.float32)


def jax_vlm_cp():
    """JAX's CP ``decode_step`` logits of the VLM's four steps under a
    (1, 2) ("data", "model") mesh (the cache laid out by its
    ``cache_pspecs``, as ``jax_cp`` builds it), after an unsharded
    prefill; made once."""
    key = "vlm_cp"
    if key not in _JAX:
        import jax
        import jax.numpy as jnp
        from repro.configs.base import ModelConfig as JaxConfig
        from repro.core import sharding as shd
        from repro.core.pspec import sharding_rules
        from repro.core.strategy import Strategy as JaxStrategy
        from repro.launch.mesh import make_mesh as jax_mesh
        from repro.models import get_model
        _, jp, _ = _jax_params(VLM_KW)
        jcfg = JaxConfig(**dict(VLM_KW, cp_decode=True))
        mod = get_model(jcfg)
        toks = jnp.asarray(VLM_CP_TOKS)
        _, cache0 = mod.prefill(
            jp, {"tokens": toks[:, :VLM_CP_PROMPT],
                 "image_embeds": jnp.asarray(VLM_CP_IMAGES)}, jcfg,
            mod.init_cache(jcfg, VLM_CP_B, VLM_CP_S))
        mesh = jax_mesh((1, 2), ("data", "model"))
        st = JaxStrategy(remat=False, dtype="float32")

        def named(specs):
            return jax.tree.map(lambda sp: jax.NamedSharding(mesh, sp),
                                specs)

        logits = []
        with sharding_rules(mesh, st.rules(mesh)):
            step = jax.jit(
                lambda p, c, t, i: mod.decode_step(p, c, t, i, jcfg),
                in_shardings=(named(shd.param_pspecs(jp, st, mesh)), None,
                              None, None))
            c = jax.device_put(cache0, named(
                shd.cache_pspecs(cache0, st, mesh, VLM_CP_B)))
            for pos in range(VLM_CP_PROMPT, VLM_CP_S):
                lg, c = step(jp, c, toks[:, pos:pos + 1],
                             jnp.asarray(pos, jnp.int32))
                logits.append(np.asarray(lg))
        _JAX[key] = logits
    return _JAX[key]


def vlm_cp_rank(world, flat):
    """The VLM's lockstep CP decode on a (1, ``world``) CPU mesh from the
    rank's shards: each step's logits, the cache's slice and shapes, and
    the collectives of the prefill and of the last decode step."""
    from repro_torch.models import vlm
    cfg = ModelConfig(**VLM_KW).with_(cp_decode=True)
    mesh = _mesh(world)
    params = from_numpy(flat, cfg, "cpu",
                        shard=(Strategy(dtype=cfg.dtype), mesh))
    view = tp.Rank.of(mesh, cfg)
    t = torch.from_numpy(VLM_CP_TOKS)
    logits = []
    with tp.active(view):
        cache = vlm.init_cache(cfg, VLM_CP_B, VLM_CP_S)
        vlm.prefill(params, {"tokens": t[:, :VLM_CP_PROMPT],
                             "image_embeds": torch.from_numpy(
                                 VLM_CP_IMAGES)}, cfg, cache)
        prefill = dict(view.counts)
        for pos in range(VLM_CP_PROMPT, VLM_CP_S):
            view.counts.clear()
            got, cache = vlm.decode_step(params, cache, t[:, pos:pos + 1],
                                         pos, cfg)
            logits.append(got.numpy())
    sl = cache["kv_slice"]
    return {"logits": logits, "counts": (prefill, dict(view.counts)),
            "slice": (sl.start, sl.length, sl.total),
            "xkv_slice": "xkv_slice" in cache, "model_rank": view.rank,
            "shapes": {k: tuple(cache[k]["k"].shape)
                       for k in ("kv_g", "kv_t", "xkv")}}


# ------------------------------------ the SSM family and the hybrid, lockstep

#: tests/test_parallel_equivalence.py::test_decode_sharded_equals_reference
#: (B 4, a cache of S 32, one decode step at position 0 from a zero cache,
#: key 1 for the init and the token, atol = rtol 5e-4) for both smokes;
#: and a 32-token prefill (one chunk) of ``SSM_TOKS`` then ``SSM_STEPS``
#: decode steps
SSM_ARCHS = ("mamba2-780m", "zamba2-1.2b")
SSM_B, SSM_S, SSM_STEPS = 4, 32, 3
SSM_TOL = 5e-4
SSM_TOKS = np.random.default_rng(30).integers(
    0, 512, size=(SSM_B, SSM_S + SSM_STEPS)).astype(np.int32)


def _ssm_cfg(arch, jax=False):
    if jax:
        from repro.configs import get_smoke as smoke
    else:
        smoke = get_smoke
    return smoke(arch).with_(dtype="float32")


def _np_tree(tree, prefix=""):
    """A nested dict of arrays flattened to numpy by "/"-joined keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_np_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def jax_ssm(arch):
    """The reference's lockstep run of ``arch``'s smoke: (its init at key 1
    flattened, the token, the zero-cache decode logits, the prefill's
    cache leaves, the decode logits after it), made once."""
    key = ("ssm", arch)
    if key not in _JAX:
        import jax
        import jax.numpy as jnp
        from repro.checkpoint.io import _flatten
        from repro.models import get_model
        jcfg = _ssm_cfg(arch, jax=True)
        mod = get_model(jcfg)
        k = jax.random.key(1)
        jp = mod.init(k, jcfg)
        tok = jax.random.randint(k, (SSM_B, 1), 0, jcfg.vocab_size)
        zero, _ = mod.decode_step(jp, mod.init_cache(jcfg, SSM_B, SSM_S),
                                  tok, jnp.asarray(0, jnp.int32), jcfg)
        toks = jnp.asarray(SSM_TOKS)
        _, c = mod.prefill(jp, {"tokens": toks[:, :SSM_S]}, jcfg,
                           mod.init_cache(jcfg, SSM_B, SSM_S + SSM_STEPS))
        leaves = _np_tree(c)
        steps = []
        for pos in range(SSM_S, SSM_S + SSM_STEPS):
            lg, c = mod.decode_step(jp, c, toks[:, pos:pos + 1],
                                    jnp.asarray(pos, jnp.int32), jcfg)
            steps.append(np.asarray(lg))
        _JAX[key] = ({k: np.asarray(v) for k, v in _flatten(jp).items()},
                     np.asarray(tok), np.asarray(zero), leaves, steps)
    return _JAX[key]


def ssm_flats():
    """What ``ssm_model_rank`` takes: each arch's (flat params, token)."""
    return {a: jax_ssm(a)[:2] for a in SSM_ARCHS}


def ssm_model_rank(mesh_shape, flats):
    """The lockstep SSM and hybrid runs on a ``mesh_shape`` ("data",
    "model") CPU mesh from the rank's shards (``from_numpy(shard=)``):
    the zero-cache decode logits, the prefill's cache leaves and
    collectives, each later decode step's logits and the last one's
    collectives."""
    from repro_torch.models import get_model
    from repro_torch.tree import flatten
    mesh = make_mesh(tuple(mesh_shape), ("data", "model"),
                     device_type="cpu")
    out = {}
    for arch in SSM_ARCHS:
        cfg = _ssm_cfg(arch)
        flat, tok = flats[arch]
        mod = get_model(cfg)
        params = from_numpy(flat, cfg, "cpu",
                            shard=(Strategy(dtype=cfg.dtype), mesh))
        view = tp.Rank.of(mesh, cfg)
        t = torch.from_numpy(SSM_TOKS)
        with tp.active(view):
            zero, _ = mod.decode_step(params,
                                      mod.init_cache(cfg, SSM_B, SSM_S),
                                      torch.from_numpy(tok), 0, cfg)
            view.counts.clear()
            cache = mod.init_cache(cfg, SSM_B, SSM_S + SSM_STEPS)
            mod.prefill(params, {"tokens": t[:, :SSM_S]}, cfg, cache)
            prefill = dict(view.counts)
            leaves = {k: v.numpy().copy() for k, v in flatten(cache).items()
                      if k != "pos"}
            steps = []
            for pos in range(SSM_S, SSM_S + SSM_STEPS):
                view.counts.clear()
                lg, cache = mod.decode_step(params, cache,
                                            t[:, pos:pos + 1], pos, cfg)
                steps.append(lg.numpy())
        out[arch] = {"zero": zero.numpy(), "leaves": leaves,
                     "steps": steps, "counts": (prefill, dict(view.counts)),
                     "model_rank": view.rank, "tp": view.tp}
    return out


def check_ssm_model_rank(got):
    """One rank's ``ssm_model_rank`` against the reference: logits within
    ``SSM_TOL``; the states JAX's for the rank's heads and the conv tails
    JAX's ``[x_r | B | C]`` channels; one ``ssm_norm`` and one
    ``ssm_out`` sum a Mamba layer (the hybrid: one ``attn_out`` and one
    ``mlp_out`` a shared-block application) besides the embedding and the
    logits, in a prefill and in a decode step — nothing else."""
    for arch in SSM_ARCHS:
        cfg = _ssm_cfg(arch)
        _, _, zero, leaves, steps = jax_ssm(arch)
        run = got[arch]
        np.testing.assert_allclose(run["zero"], zero, atol=SSM_TOL,
                                   rtol=SSM_TOL, err_msg=arch)
        for i, want in enumerate(steps):
            np.testing.assert_allclose(run["steps"][i], want, atol=SSM_TOL,
                                       rtol=SSM_TOL, err_msg=f"{arch} {i}")
        n, r = run["tp"], run["model_rank"]
        h = cfg.ssm_heads // n
        conv = tp.Segmented("model", tp.ssm_segments(cfg, "conv_b"))
        chans = np.concatenate([np.arange(a, a + k)
                                for a, k, _ in conv.runs(n, r)])
        for key, leaf in run["leaves"].items():
            want = leaves[key]
            if key.endswith("/state"):
                want = want[:, :, r * h:(r + 1) * h]
            elif key.endswith("/conv"):
                want = want[..., chans]
            elif key.startswith("kv/"):
                hk = leaf.shape[3]
                want = want[:, :, :, r * hk:(r + 1) * hk]
            assert leaf.shape == want.shape, (arch, key)
            np.testing.assert_allclose(leaf, want, atol=SSM_TOL,
                                       rtol=SSM_TOL, err_msg=f"{arch} {key}")
        g, _ = cfg.hybrid_groups if cfg.arch_type == "hybrid" else (0, 0)
        mamba = g * cfg.hybrid_attn_every if g else cfg.num_layers
        want_counts = {"ssm_norm": mamba, "ssm_out": mamba, "embed": 1,
                       "logits": 1}
        if g:
            want_counts.update(attn_out=g, mlp_out=g)
        for counts in run["counts"]:
            assert counts == want_counts, (arch, counts)


# ------------------------------------------------------------- the ranks

def _mesh(world):
    torch.set_num_threads(1)
    return make_mesh((1, world), ("data", "model"), device_type="cpu")


def _engine_rank(rank, world, flats, runs):
    """Every engine run on this rank: the full params handed to the engine
    (it shards them) on even runs, only the rank's blocks from the bridge
    (``from_numpy(shard=)``) on odd ones."""
    from repro_torch.serve.speculative import SpecConfig
    mesh = _mesh(world)
    out = {}
    for i, (name, (kw, prompts, new, ekw)) in enumerate(runs.items()):
        cfg = ModelConfig(**kw)
        shard = (Strategy(dtype=cfg.dtype), mesh) if i % 2 else None
        params = from_numpy(flats[_weights(kw)], cfg, "cpu", shard=shard)
        eng = ServeEngine(cfg, params, mesh=mesh,
                          **_spec_kw(ekw, SpecConfig))
        for j, p in enumerate(prompts):
            eng.submit(j, p, max_new=new)
        res = eng.run()
        out[name] = {"streams": {j: list(res[j].out) for j in res},
                     "done": all(r.done for r in res.values()),
                     "stats": {k: eng.stats[k] for k in COUNTERS
                               + ("mixed_steps",)},
                     "tp": eng.tp, "kv_bytes": eng.kv_bytes(),
                     "per_device": eng.per_device_kv_bytes(),
                     "counts": dict(eng._rank.counts)}
    return out


def _family_rank(rank, world, flats, runs):
    """Every run of ``FAMILY_RUNS`` on this rank, the full params handed
    to the engine."""
    mesh = _mesh(world)
    out = {}
    for name, (kw, prompts, media, new, ekw) in runs.items():
        cfg = ModelConfig(**kw)
        eng = ServeEngine(cfg, from_numpy(flats[kw["name"]], cfg, "cpu"),
                          mesh=mesh, **ekw)
        for j, p in enumerate(prompts):
            eng.submit(j, p, max_new=new, **_media(kw, media, j))
        res = eng.run()
        out[name] = {"streams": {j: list(res[j].out) for j in res},
                     "done": all(r.done for r in res.values()),
                     "stats": {k: eng.stats[k] for k in COUNTERS
                               + ("mixed_steps", "encode_traces")},
                     "per_device": eng.per_device_kv_bytes(),
                     "kv_bytes": eng.kv_bytes(),
                     "state_bytes": state_bytes(eng),
                     "experts": eng.params["layers"]["moe"]["w_up"].shape[1]
                     if cfg.is_moe else None,
                     "w_up": tuple(eng.params["layers"]["moe"]["w_up"].shape)
                     if cfg.is_moe else None,
                     "counts": dict(eng._rank.counts),
                     "bytes": dict(eng._rank.bytes),
                     "kv_shapes": {k: tuple(eng._cache[k]["k"].shape)
                                   for k in ("kv", "kv_g", "xkv")
                                   if k in eng._cache},
                     "slices": {k: (v.start, v.length, v.total)
                                for k, v in eng._cache.items()
                                if isinstance(v, tp.SeqSlice)}}
    return out


def state_bytes(eng) -> int:
    """Bytes of an engine's SSM states (every ``state`` leaf)."""
    from repro_torch.tree import flatten
    return sum(v.numel() * v.element_size()
               for k, v in flatten(eng._cache).items()
               if k.endswith("/state"))


def _vlm_smoke():
    """The VLM smoke config in f32, its params from seed 4 with both gates
    opened to 1.0, and three requests' (16, 256) images from seed 13."""
    from repro_torch.params import init_params
    cfg = get_smoke("llama-3.2-vision-90b").with_(dtype="float32")
    params = init_params(cfg, device="cpu", seed=4)
    for gate in ("gate_attn", "gate_mlp"):
        params["cross"][gate].fill_(1.0)
    images = np.random.default_rng(13).standard_normal(
        (3, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return cfg, params, images


#: ``_logits_rank``'s runs: (name, config, strategy)
LOGITS_RUNS = (("par-dense", KW, Strategy(dtype="float32")),
               ("par-dense-kv1", KW_KV1, Strategy(dtype="float32")),
               ("par-moe", MOE_KW, Strategy(dtype="float32")),
               ("par-moe-tie", MOE_KW, TIE))


def _logits_rank(rank, world, flats, toks):
    """Prefill 20 tokens and decode 4 on the dense cache, under tp, for
    each config; with the collectives of the prefill and of the last
    decode step, and what a training forward says under the mesh."""
    from repro_torch.models import transformer
    mesh = _mesh(world)
    out = {}
    for name, kw, st in LOGITS_RUNS:
        cfg = ModelConfig(**kw)
        params = from_numpy(flats[kw["name"]], cfg, "cpu", shard=(st, mesh))
        rank_view = tp.Rank.of(mesh, cfg)
        cache = transformer.init_cache(
            cfg.with_(num_kv_heads=rank_view.kv_heads), 2, 40)
        logits, counts = [], []
        with tp.active(rank_view):
            t = torch.from_numpy(toks)
            transformer.prefill(params, {"tokens": t[:, :20]}, cfg, cache)
            counts.append(dict(rank_view.counts))
            for pos in range(20, 24):
                rank_view.counts.clear()
                got, cache = transformer.decode_step(
                    params, cache, t[:, pos:pos + 1], pos, cfg)
                logits.append(got.numpy())
            counts.append(dict(rank_view.counts))
            rank_view.counts.clear()
            with torch.no_grad():
                full, _ = transformer.forward(params, {"tokens": t}, cfg)
            counts.append(dict(rank_view.counts))
        out[name] = {"logits": logits, "counts": counts,
                     "forward": full.numpy(),
                     "cache_heads": cache["kv"]["k"].shape[3]}
    return out


def _session_rank(rank, world):
    """(d): ``Session.serve(tp=2)`` and ``Session.serve()`` of one
    session (random weights from its seed: the tp engine draws only the
    rank's blocks), and the refusals of (g)."""
    from repro_torch.api import Session
    from repro_torch.params import init_params
    _mesh(world)
    cfg = ModelConfig(**KW)
    prompts = _prompts(3, (5, 7, 6))
    out = {}
    for tp_n in (None, world):
        session = Session(cfg, device="cpu", seed=3)
        eng = session.serve(tp=tp_n, slots=2, max_len=64)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=6)
        res = eng.run()
        out[tp_n or 1] = ({i: list(res[i].out) for i in res},
                          eng.stats["decode_traces"], eng.tp)
    # the MoE and enc-dec families through the session: the tp engine
    # draws only the rank's blocks (experts, heads, vocabulary); the MoE
    # also with TP inside each expert (each expert's d_ff)
    for kw in (MOE_KW, AUDIO_KW):
        fcfg = ModelConfig(**kw)
        frames = _AUDIO[1] if fcfg.arch_type == "audio" else None
        got = []
        runs = ((None, None), (world, None)) \
            + (((world, TIE),) if fcfg.is_moe else ())
        for tp_n, st in runs:
            eng = Session(fcfg, strategy=st, device="cpu", seed=4).serve(
                tp=tp_n, slots=2, max_len=32)
            for i, p in enumerate(_AUDIO[0]):
                eng.submit(i, p, max_new=4,
                           frames=None if frames is None else frames[i])
            res = eng.run()
            got.append({i: list(res[i].out) for i in res})
        out[kw["name"]] = got
    # the VLM smoke with its gates open, each request with its images:
    # serve(tp=2) slices the session's params to the rank's shards
    vcfg, vparams, images = _vlm_smoke()
    prompts = _prompts(3, (5, 7, 6), vocab=vcfg.vocab_size)
    got = []
    for tp_n in (None, world):
        eng = Session(vcfg, device="cpu", params=vparams).serve(
            tp=tp_n, slots=2, max_len=32)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=4, images=images[i])
        res = eng.run()
        got.append({i: list(res[i].out) for i in res})
    out[vcfg.name] = got
    refused = {}
    try:
        make_mesh((1, 2 * world), ("data", "model"), device_type="cpu")
    except ValueError as e:
        refused["mesh"] = str(e)
    mesh = _mesh(world)
    built = {}
    for family, extra in (("moe", dict(num_experts=4, experts_per_token=2)),
                          ("audio", dict(num_kv_heads=4, encoder_layers=1,
                                         encoder_ctx=8)),
                          ("ssm", dict(ssm_heads=4, ssm_head_dim=16,
                                       ssm_state=8, ssm_chunk=16)),
                          ("vlm", dict(num_layers=3, cross_attn_every=2,
                                       num_image_tokens=8))):
        fcfg = cfg.with_(arch_type=family, **extra)
        try:
            built[family] = ServeEngine(
                fcfg, init_params(fcfg, device="cpu", seed=0),
                mesh=mesh).tp
        except NotImplementedError as e:
            refused[family] = str(e)
    out["built"] = built
    # a one-pod ("pod", "data", "model") mesh: the engine serves its one
    # row; an axis beside those three is refused
    eng = ServeEngine(cfg, init_params(cfg, device="cpu", seed=0),
                      mesh=make_mesh((1, 1, world), ("pod", "data", "model"),
                                     device_type="cpu"),
                      slots=2, max_len=64)
    for i, p in enumerate(prompts):
        eng.submit(i, p, max_new=4)
    out["pod"] = ({i: list(r.out) for i, r in eng.run().items()}, eng.tp,
                  dict(eng._rank.counts))
    try:
        ServeEngine(cfg, init_params(cfg, device="cpu", seed=0),
                    mesh={"pipe": 1, "data": 1, "model": world})
    except ValueError as e:
        refused["pipe"] = str(e)
    # SSD heads that do not split over the ranks
    odd = cfg.with_(arch_type="ssm", ssm_heads=3, ssm_head_dim=16,
                    ssm_state=8, ssm_chunk=16)
    try:
        ServeEngine(odd, init_params(odd, device="cpu", seed=0), mesh=mesh)
    except ValueError as e:
        refused["ssm_heads"] = str(e)
    # fsdp and seq_parallel: the Megatron layout, the same streams
    flags = {}
    for st in (Strategy(dtype="float32"),
               Strategy(dtype="float32", fsdp=True, seq_parallel=True)):
        eng = ServeEngine(cfg, init_params(cfg, device="cpu", seed=0),
                          mesh=mesh, strategy=st, slots=2, max_len=64)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=4)
        res = eng.run()
        flags[st.fsdp] = ({i: list(res[i].out) for i in res},
                          tuple(eng.params["layers"]["mlp"]["w_up"].shape),
                          dict(eng._rank.counts))
    out["flags"] = flags
    # d_ff 264 takes the MLP kernel whole (a multiple of 8), not its rank
    # block of 132: refused at construction on a CUDA device (no card
    # needed to refuse)
    bad = cfg.with_(dtype="bfloat16", d_ff=264)
    try:
        ServeEngine(bad, init_params(bad, device="cpu", seed=0), mesh=mesh,
                    device="cuda")
    except ValueError as e:
        refused["rank_shape"] = str(e)
    # ranks whose host engines diverge (here: different submissions) stop
    # at the checksum before the program, on every rank, on either path
    for mixed in (True, False):
        eng = ServeEngine(cfg, init_params(cfg, device="cpu", seed=0),
                          mesh=mesh, mixed=mixed, slots=2, max_len=64)
        eng.submit(0, np.arange(5 + rank, dtype=np.int32), max_new=2)
        try:
            eng.run()
        except RuntimeError as e:
            refused[f"diverged mixed={mixed}"] = str(e)
    out["refused"] = refused
    return out


def _online_rank(rank, world, flat):
    """The online driver over the ``world`` ranks, one case of
    ``ONLINE_RUNS`` after another, each on a fresh engine; rank 0 takes
    every submission. Returns each case's streams, records, metrics and
    each rank's engine counters and collectives."""
    import json
    import logging
    import time
    import urllib.request
    from repro_torch.api import Session
    from repro_torch.serve.driver import AsyncDriver
    mesh = _mesh(world)
    cfg = ModelConfig(**ONLINE_KW)
    params = from_numpy(flat, cfg, "cpu")
    lead = rank == 0
    out = {}

    def engine():
        return ServeEngine(cfg, params, mesh=mesh, **ONLINE_ENG)

    def counters(eng):
        return {"stats": {k: eng.stats[k] for k in COUNTERS
                          + ("expired", "step_count")},
                "counts": dict(eng._rank.counts)}

    # deferred start: rank 0 submits, every rank starts
    prompts, new = ONLINE_RUNS["deferred"]
    eng = engine()
    drv = AsyncDriver(eng, start=False)
    streams = [drv.submit(p, max_new=new, rid=i)
               for i, p in enumerate(prompts)] if lead else []
    refused = None
    if not lead:
        try:
            drv.submit(prompts[0], max_new=new)
        except RuntimeError as e:
            refused = str(e)
    drv.start()
    got = {s.rid: s.tokens() for s in streams}
    records = {s.rid: s.result(timeout=60.0) for s in streams}
    drv.stop()
    out["deferred"] = {
        "streams": got, "records": {i: list(r.out)
                                    for i, r in records.items()},
        "done": all(r.done for r in records.values()),
        "ttft": drv.metrics.ttft.count, "lead": drv.lead,
        "refused": refused, "passes": drv._chan.passes,
        "left": (len(eng.finished), len(drv._streams)), **counters(eng)}

    # live submission through Session.serve_async(tp=), started at once
    prompts, new = ONLINE_RUNS["live"]
    drv = Session(cfg, device="cpu", params=params).serve_async(
        tp=world, **ONLINE_ENG)
    got = {}
    if lead:
        streams = []
        for i, p in enumerate(prompts):
            streams.append(drv.submit(p, max_new=new, rid=i))
            time.sleep(0.01)            # interleave with stepping
        got = {s.rid: list(s.result(timeout=60.0).out) for s in streams}
    drv.stop()
    out["live"] = {"streams": got, **counters(drv.engine)}

    # a deadline that passes while the request waits behind two others
    prompts, new = ONLINE_RUNS["deadline"]
    eng = engine()
    drv = AsyncDriver(eng, start=False)
    if lead:
        streams = [drv.submit(p, max_new=new, rid=i)
                   for i, p in enumerate(prompts[:2])]
        late = drv.submit(prompts[2], max_new=new, rid=2, deadline_s=1e-3)
        time.sleep(0.01)
    drv.start()
    got = {}
    if lead:
        got = {s.rid: list(s.result(timeout=60.0).out) for s in streams}
        rec = late.result(timeout=60.0)
        got["late"] = (list(rec.out), rec.done, rec.expired)
    drv.stop()
    out["deadline"] = {"streams": got,
                       "expired": drv.metrics.expired.value,
                       **counters(eng)}

    # a stall on rank 0 fires its watchdog: every rank requeues
    prompts, new = ONLINE_RUNS["watchdog"]
    eng = engine()
    eng.submit(100, prompts[0], max_new=2)     # warm, in lockstep
    eng.run()
    calls = {"n": 0}

    def stalled(d):
        calls["n"] += 1
        if lead and calls["n"] == 2:           # rid 0 is mid-decode
            deadline = time.monotonic() + 20.0
            while not d.abort_step.is_set() and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
        d.engine.step()

    lines = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("repro_torch.serve")
    logger.addHandler(handler)
    try:
        drv = AsyncDriver(eng, watchdog_timeout=0.5, step_fn=stalled,
                          start=False)
        stream = drv.submit(prompts[0], max_new=new, rid=0) if lead \
            else None
        drv.start()
        rec = stream.result(timeout=60.0) if lead else None
        drv.stop()
    finally:
        logger.removeHandler(handler)
    out["watchdog"] = {
        "out": None if rec is None else (list(rec.out), rec.done),
        "fired": drv.metrics.watchdog_fired.value,
        "requeued": drv.metrics.watchdog_requeued.value,
        "abort": drv.abort_step.is_set(), "log": "\n".join(lines),
        **counters(eng)}

    # stop(drain=False) mid-flight: every rank returns, records partial
    prompts, new = ONLINE_RUNS["stop"]
    eng = engine()

    def slow(d):
        d.engine.step()
        if lead:
            time.sleep(0.05)

    drv = AsyncDriver(eng, step_fn=slow, start=False)
    streams = [drv.submit(p, max_new=new, rid=i)
               for i, p in enumerate(prompts)] if lead else []
    drv.start()
    got = {}
    if lead:
        it = iter(streams[0])
        first = [next(it), next(it)]
        drv.stop(drain=False)
        got = {s.rid: (list(s.result(timeout=10.0).out),
                       s.result(timeout=10.0).done) for s in streams}
        got["first"] = first
    else:
        drv.stop()
    out["stop"] = {"streams": got, "ended": drv.wait(0.0),
                   "error": repr(drv.error), **counters(eng)}

    # HTTP on rank 0 through Session.serve_http(tp=): /generate (JSON,
    # chunked), then /metrics and /healthz with the loop idle
    prompts, new = ONLINE_RUNS["http"]
    server = Session(cfg, device="cpu", params=params).serve_http(
        tp=world, port=0, **ONLINE_ENG)
    http = {"url": server.url}
    if lead:
        def post(body):
            req = urllib.request.Request(
                f"{server.url}/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            return urllib.request.urlopen(req, timeout=60)

        with post({"prompt": [int(t) for t in prompts[0]],
                   "max_new": new}) as r:
            http["json"] = json.loads(r.read())
        with post({"prompt": [int(t) for t in prompts[1]],
                   "max_new": new, "stream": True}) as r:
            http["chunked"] = r.headers["Transfer-Encoding"]
            http["lines"] = [json.loads(ln) for ln in r if ln.strip()]
        time.sleep(0.3)                 # a few idle passes
        with urllib.request.urlopen(f"{server.url}/metrics",
                                    timeout=30) as r:
            http["metrics"] = r.read().decode()
        with urllib.request.urlopen(f"{server.url}/healthz",
                                    timeout=30) as r:
            http["health"] = json.loads(r.read())
    server.close()
    out["http"] = {**http, **counters(server.driver.engine)}

    # a fault feeds the follower a different prompt: the engines'
    # checksum before the program raises on every rank
    prompts, new = ONLINE_RUNS["deferred"]
    eng = engine()
    drv = AsyncDriver(eng, start=False)
    if not lead:
        real = drv._chan.exchange

        def faulty(batch):
            batch = real(batch)
            batch["events"] = [
                (ev[0], ev[1], (ev[2] + 1) % 128, *ev[3:])
                if ev[0] == "submit" else ev for ev in batch["events"]]
            return batch

        drv._chan.exchange = faulty
    stream = drv.submit(prompts[0], max_new=new, rid=0) if lead else None
    drv.start()
    rec = stream.result(timeout=60.0) if lead else None
    drv.stop()
    out["diverged"] = {"error": repr(drv.error), "ended": drv.wait(0.0),
                       "done": None if rec is None else rec.done}
    return out


#: the "dp" search's 2-chip plan for ``KW`` (dp 1 x tp 2, seq_parallel):
#: a prefill of 256 tokens, as phase 19 of chip_smoke.py serves
PLAN_SHAPE = ("prefill_256", 256, 1, "prefill")
PLAN_PROMPTS = _prompts(3, (5, 7, 6))
PLAN_ENG = dict(slots=2, max_len=64)


def _jax_plan_serve(mixed):
    """JAX's ``Session.from_plan(..., devices=2).serve(mixed=)`` of the
    "dp" search's 2-chip plan (on H100's fields) on ``KW``'s weights:
    (the plan's row, the streams); made once."""
    key = ("plan", mixed)
    if key not in _JAX:
        import dataclasses
        from repro.api import Session as JaxSession
        from repro.api import plan as jax_plan
        from repro.configs.base import ShapeConfig as JaxShape
        from repro.core.costmodel import Hardware as JaxHardware
        from repro_torch.core.costmodel import H100
        jcfg, jparams, _ = _jax_params(KW)
        p = jax_plan(jcfg, JaxShape(*PLAN_SHAPE), 2, method="dp",
                     hw=JaxHardware(**dataclasses.asdict(H100)))
        session = JaxSession.from_plan(jcfg, p, devices=2, dtype="float32")
        session.params = jparams
        eng = session.serve(mixed=mixed, **PLAN_ENG)
        for i, pr in enumerate(PLAN_PROMPTS):
            eng.submit(i, pr, max_new=6)
        res = eng.run()
        _JAX[key] = (p.row(), {i: list(res[i].out) for i in res})
    return _JAX[key]


def _plan_rank(rank, world, flat):
    """``Plan.materialize`` on the two ranks (its refusals, the
    single-axis and pipe layouts, the strategy and its overrides) and
    ``Session.from_plan`` of the "dp" search's plan for ``KW``, serving
    mixed and split on JAX's weights (the params setter)."""
    from repro_torch.api import Degrees, Plan, Session, plan
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.strategy import mesh_axes
    cfg, shape = ModelConfig(**KW), ShapeConfig(*PLAN_SHAPE)
    out, refused = {}, {}

    def manual(**kw):
        return Plan(degrees=Degrees(**kw), cost=0.0, mfu=0.0, fits=True,
                    evaluations=1, method="manual")

    for name, p, devices in (("tile", manual(dp=3), None),
                             ("tile 1", manual(dp=2), 1),
                             ("available", manual(dp=2), 2 * world),
                             ("ep", manual(tp=2, ep=3), None)):
        try:
            p.materialize(devices=devices, device_type="cpu")
        except ValueError as e:
            refused[name] = str(e)
    out["refused"] = refused
    layouts = {}
    for name, deg in (("model", Degrees(tp=2, microbatches=2,
                                        seq_parallel=True, remat=False)),
                      ("pipe", Degrees(pp=2, microbatches=4)),
                      ("data", Degrees(dp=2, fsdp=True, zero1=False))):
        st, mesh = Plan.from_degrees(cfg, ShapeConfig("host", 64, 8, "train"),
                                     deg).materialize(device_type="cpu",
                                                      dtype="float32")
        layouts[name] = (mesh_axes(mesh), tp.coordinate(mesh), st)
    out["layouts"] = layouts
    p = plan(cfg, shape, world, method="dp")
    session = Session.from_plan(cfg, p, device="cpu", dtype="float32")
    session.params = from_numpy(flat, cfg, "cpu")
    out["row"], out["strategy"] = p.row(), session.strategy
    for mixed in (True, False):
        eng = session.serve(mixed=mixed, **PLAN_ENG)
        for i, pr in enumerate(PLAN_PROMPTS):
            eng.submit(i, pr, max_new=6)
        res = eng.run()
        out[mixed] = ({i: list(res[i].out) for i in res}, eng.tp,
                      eng.mixed, session.mesh is eng.mesh)
    return out


# --------------------------------------------------------- the spawns

def _all_ranks(rank, world, flats, runs, family_runs, toks):
    """Every case of this module on one rank: one spawn for all."""
    return {"engine": _engine_rank(rank, world, flats, runs),
            "family": _family_rank(rank, world, flats, family_runs),
            "ssm": ssm_model_rank((1, world), flats["ssm"]),
            "logits": _logits_rank(rank, world, flats, toks),
            "session": _session_rank(rank, world),
            "cp": {p: cp_rank((1, world), flats["cp"], p)
                   for p in (CP_PROMPT, CP_SHORT)},
            "cp_extra": _cp_extra_rank(world, flats["cp"]),
            "vlm_cp": vlm_cp_rank(world, flats[VLM_KW["name"]]),
            "online": _online_rank(rank, world, flats[ONLINE_KW["name"]]),
            "plan": _plan_rank(rank, world, flats[KW["name"]])}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both ranks' results of every case, from one spawn."""
    toks = np.random.default_rng(5).integers(0, 128, size=(2, 24)).astype(
        np.int32)
    flats = {kw["name"]: _flat(kw)
             for kw in (KW, KW_KV1, MOE_KW, MOE_E3_KW, AUDIO_KW,
                        AUDIO_KV1_KW, ONLINE_KW, SSM_KW, ZAMBA_KW,
                        ZAMBA_KV1_KW, VLM_KW, VLM_KV1_KW)}
    flats["cp"] = _jax_cp_params()[2]
    flats["ssm"] = ssm_flats()
    return toks, run_ranks(_all_ranks, 2,
                           args=(flats, RUNS, FAMILY_RUNS, toks),
                           store_dir=str(tmp_path_factory.mktemp("tp")),
                           timeout=RANK_TIMEOUT)


@pytest.fixture(scope="module")
def engine_runs(spawned):
    ranks = [r["engine"] for r in spawned[1]]
    # every rank ran the same host engine: same streams, same counters
    assert all(r[n]["streams"] == ranks[0][n]["streams"]
               and r[n]["stats"] == ranks[0][n]["stats"]
               for r in ranks for n in RUNS)
    return ranks[0]


@pytest.fixture(scope="module")
def family_runs(spawned):
    ranks = [r["family"] for r in spawned[1]]
    assert all(r[n]["streams"] == ranks[0][n]["streams"]
               and r[n]["stats"] == ranks[0][n]["stats"]
               for r in ranks for n in FAMILY_RUNS)
    return ranks


@pytest.fixture(scope="module")
def model_runs(spawned):
    toks, ranks = spawned
    return (toks, [r["logits"] for r in ranks],
            [r["session"] for r in ranks])


# ----------------------------------------------------------------- (a)-(c)

def test_tp2_mixed_matches_jax_tp1(engine_runs):
    """tests/test_serve_parallel.py:315: the head-sharded engine's
    streams equal the JAX engine's, one program shape, no prefill
    program, the global pool bytes unchanged and half of them on each
    rank; one all-reduce each after ``wo`` and ``w_down`` a layer, one
    for the embedding and one for the logits, a program run."""
    want, jstats, jkv, jdev = _jax_run("mixed")
    run = engine_runs["mixed"]
    assert run["tp"] == 2 and run["done"]
    assert run["streams"] == want
    assert run["stats"]["decode_traces"] == 1
    assert run["stats"]["prefill_traces"] == 0
    assert run["kv_bytes"] == jkv
    assert run["per_device"] * 2 == jdev
    steps, layers = run["stats"]["mixed_steps"], KW["num_layers"]
    assert {k: run["counts"][k] for k in ("attn_out", "mlp_out", "embed",
                                          "logits", "tokens")} == \
        {"attn_out": layers * steps, "mlp_out": layers * steps,
         "embed": steps, "logits": steps, "tokens": steps}
    # one checksum a program, one clock a step
    assert run["counts"]["step_check"] == steps
    assert run["counts"]["clock"] >= steps


@pytest.mark.parametrize("name", ["split_pool", "split_dense", "ring",
                                  "split_dense_kv1", "ring_kv1"])
def test_tp2_split_path_matches_jax_tp1(engine_runs, name):
    """The split path under tp 2, on the pool, on dense rows and on the
    sliding-window ring (window 8 < the contexts): the JAX engine's
    streams and program shapes, half the decode state on each rank. With
    one KV head the dense rows and the ring hold each rank's sequence
    slice (the reference's ``cache_pspecs``) and every decode step is
    context-parallel: one head-assembly sum, one MAX and one SUM a layer,
    and no K/V assembled in the prefill (both ranks compute the head)."""
    want, jstats, jkv, jdev = _jax_run(name)
    run = engine_runs[name]
    assert run["done"] and run["streams"] == want
    for key in ("decode_traces", "prefill_traces", "prefills",
                "decode_steps"):
        assert run["stats"][key] == jstats[key], key
    assert run["kv_bytes"] == jkv and run["per_device"] * 2 == jkv
    counts, layers = run["counts"], KW["num_layers"]
    cp = {k: counts.get(k, 0) for k in ("cp_qkv", "cp_max", "cp_sum")}
    steps = run["stats"]["decode_steps"] if name.endswith("kv1") else 0
    assert cp == dict.fromkeys(cp, layers * steps)
    assert "prefill_kv" not in counts


@pytest.mark.parametrize("name", ["prefix", "prefix_dry"])
def test_tp2_prefix_cache_lazy_matches_jax_tp1(engine_runs, name):
    """tests/test_serve_parallel.py:377 and a pool below demand: sharing,
    lazy growth, preemption and copy-on-write under tp 2 — the JAX
    engine's streams and every prefix, preemption and CoW counter."""
    want, jstats, _, _ = _jax_run(name)
    run = engine_runs[name]
    assert run["done"] and run["streams"] == want
    for key in COUNTERS:
        assert run["stats"][key] == jstats[key], key
    assert run["stats"]["prefix_hit_blocks"] > 0
    if name == "prefix_dry":
        assert run["stats"]["preemptions"] > 0
        assert run["stats"]["cow_copies"] > 0


def test_tp2_speculative_decode_matches_jax_tp1(engine_runs):
    """Speculative decode (ngram, k 4) under tp 2: the drafts are host
    work every rank does alike; the JAX engine's streams, drafted and
    accepted counts, one program shape."""
    want, jstats, _, _ = _jax_run("spec")
    run = engine_runs["spec"]
    assert run["done"] and run["streams"] == want
    for key in COUNTERS:
        assert run["stats"][key] == jstats[key], key
    assert run["stats"]["spec_accepted"] > 0
    assert run["stats"]["decode_traces"] == 1


def test_tp2_one_kv_head_replicates_the_pool(engine_runs):
    """Hkv 1 at tp 2: the pool keeps its one head on both ranks (the
    table's replicated fallback), each rank's two query heads read it;
    the JAX engine's streams, and the per-rank bytes are the global."""
    want, _, jkv, _ = _jax_run("kv1")
    run = engine_runs["kv1"]
    assert run["done"] and run["streams"] == want
    assert run["kv_bytes"] == run["per_device"] == jkv


# --------------------------------------------------------------- (d)-(g)

def test_session_serve_tp2_matches_plain(model_runs):
    """tests/test_serve_parallel.py:528: ``Session.serve(tp=2)`` (only
    the rank's blocks drawn from the session's seed) gives the streams of
    ``Session.serve()`` on the same session, one program shape; on the
    MoE (its experts over "model", and with ``Strategy(expert_parallel=
    False)`` each expert's d_ff) and enc-dec configs as well, and on the
    VLM smoke with its gates
    open and each request's images (the session's params sliced to the
    rank's shards)."""
    _, _, session = model_runs
    for r in session:
        assert r[2][0] == r[1][0]
        assert r[2][1] == 1 and r[2][2] == 2 and r[1][2] == 1
        # the MoE, enc-dec and VLM configs too: serve(tp=2) == serve()
        for name in (MOE_KW["name"], AUDIO_KW["name"], "llama-vision-smoke"):
            assert r[name][1] == r[name][0], name
        assert r[MOE_KW["name"]][2] == r[MOE_KW["name"]][0]


@pytest.mark.parametrize("name", [run[0] for run in LOGITS_RUNS])
def test_tp2_decode_logits_match_jax(model_runs, name):
    """Four decode steps after a 20-token prefill on the dense cache,
    under tp 2: logits within LOGITS_TOL of the reference's
    ``decode_step`` on both ranks (with one KV head, both ranks hold it
    and read it; the MoE, its experts over "model" or each expert's d_ff
    split, within MOE_LOGITS_TOL)."""
    import jax.numpy as jnp
    from repro.models import get_model
    toks, logits, _ = model_runs
    kw = {run[0]: run[1] for run in LOGITS_RUNS}[name]
    tol = MOE_LOGITS_TOL if kw is MOE_KW else LOGITS_TOL
    jcfg, jparams, _ = _jax_params(kw)
    mod = get_model(jcfg)
    _, jcache = mod.prefill(jparams, {"tokens": jnp.asarray(toks[:, :20])},
                            jcfg, mod.init_cache(jcfg, 2, 40))
    for pos in range(20, 24):
        want, jcache = mod.decode_step(jparams, jcache,
                                       jnp.asarray(toks[:, pos:pos + 1]),
                                       jnp.asarray(pos, jnp.int32), jcfg)
        for r in logits:
            np.testing.assert_allclose(r[name]["logits"][pos - 20],
                                       np.asarray(want), atol=tol,
                                       rtol=0, err_msg=str(pos))
    # one K/V head a rank: Hkv 2 split over 2 ranks, or Hkv 1 on both
    assert [r[name]["cache_heads"] for r in logits] == [1, 1]


def test_tp2_forward_has_two_all_reduces_a_layer(model_runs):
    """tests/test_tp_collectives.py's claim in the port: a prefill, a
    decode step and the training forward (``transformer.forward``, which
    runs under a mesh) each issue exactly one all-reduce after attention
    and one after the MLP a layer, one for the vocab-parallel embedding
    and one to assemble the logits — nothing else; the forward's logits
    within LOGITS_TOL of the reference's ``forward``."""
    import jax.numpy as jnp
    from repro.models import get_model
    toks, logits, _ = model_runs
    layers = KW["num_layers"]
    want = {"attn_out": layers, "mlp_out": layers, "embed": 1,
            "logits": 1}
    for name, kw in (("par-dense", KW), ("par-dense-kv1", KW_KV1)):
        jcfg, jparams, _ = _jax_params(kw)
        ref, _ = get_model(jcfg).forward(
            jparams, {"tokens": jnp.asarray(toks)}, jcfg)
        for r in logits:
            prefill, decode, forward = r[name]["counts"]
            assert prefill == want and decode == want and forward == want
            np.testing.assert_allclose(r[name]["forward"], np.asarray(ref),
                                       atol=LOGITS_TOL, rtol=0)


def test_tp_refusals(model_runs):
    """A mesh larger than the process group raises ValueError with the
    count; MoE, audio, SSM and VLM engines build on a mesh; a one-pod
    ("pod", "data", "model") mesh serves the streams and collectives of
    the ("data", "model") engine, while a mesh with another axis
    ("pipe") raises ValueError naming the axes; an engine under FSDP and
    sequence parallelism serves the Megatron layout (the streams, blocks
    and collectives of one without them); on a CUDA device a
    kernel that refuses a rank's shape refuses at construction; ranks
    that packed different programs raise on every rank (no hang);
    ``serve(dp=2)`` on the one CPU device raises the reference's "devices
    needed", and ``serve(plan=)`` takes the plan's degrees: tp 2 needs
    the ranks, pp 2 raises the reference's ValueError. An SSM engine
    builds on the mesh; one whose SSD heads do not split over the ranks
    raises ValueError naming the config."""
    from repro_torch.api import Session
    _, _, session = model_runs
    refused = session[0]["refused"]
    assert "needs 4 ranks" in refused["mesh"] and "has 2" in refused["mesh"]
    assert "'pipe'" in refused["pipe"] and "'pod'" in refused["pipe"]
    # a one-pod mesh serves the streams, with the collectives, of the
    # ("data", "model") engine on the same weights
    for r in session:
        streams, tp_n, counts = r["pod"]
        plain = r["flags"][False]
        assert tp_n == 2 and streams == plain[0] and counts == plain[2]
    # fsdp and seq_parallel serve the Megatron layout: the streams, the
    # blocks and the collectives of the engine without them
    for r in session:
        plain, flagged = r["flags"][False], r["flags"][True]
        assert flagged == plain and plain[1] == (2, 128, 128)
    assert not {"moe", "audio", "ssm", "vlm"} & set(refused)
    assert session[0]["built"] == {"moe": 2, "audio": 2, "ssm": 2,
                                   "vlm": 2}
    assert "3 SSD heads" in refused["ssm_heads"]
    assert "fused-MLP kernel" in refused["rank_shape"]
    assert "132" in refused["rank_shape"]
    for r in session:
        for mixed in (True, False):
            assert "packed different programs" in \
                r["refused"][f"diverged mixed={mixed}"]
    s = Session(ModelConfig(**KW), device="cpu", seed=0)
    with pytest.raises(ValueError, match="devices needed"):
        s.serve(dp=2)
    with pytest.raises(ValueError, match="no process group"):
        s.serve(tp=2)
    # a plan's tp 2 needs the ranks; its pp 2 raises unless tp= and dp=
    from repro_torch.api import Degrees, Plan
    from repro_torch.configs.base import ShapeConfig
    shape = ShapeConfig(*PLAN_SHAPE)
    with pytest.raises(ValueError, match="no process group"):
        s.serve(plan=Plan.from_degrees(s.cfg, shape, Degrees(tp=2)))
    with pytest.raises(ValueError, match="pp=2"):
        s.serve(plan=Plan.from_degrees(s.cfg, shape, Degrees(pp=2)))


# ------------------------------------------- expert-parallel MoE, enc-dec

@pytest.mark.parametrize("name", ["moe_mixed", "moe_split"])
def test_tp2_moe_matches_jax_tp1(family_runs, name):
    """tests/test_serve_parallel.py:336 (one slot, 8-token pages) on the
    mixed step and the split path: two experts a rank, the JAX engine's
    tp 1 streams and counters, one program shape, half the pool a rank,
    and one ``moe_out`` all-reduce a layer a program (where a dense
    layer has its ``mlp_out``)."""
    want, jstats, jdev = _jax_family_run(name)
    for r in family_runs:
        run = r[name]
        assert run["done"] and run["streams"] == want
        for key in COUNTERS:
            assert run["stats"][key] == jstats[key], key
        assert run["stats"]["decode_traces"] == 1
        assert run["per_device"] * 2 == jdev
        assert run["experts"] == MOE_KW["num_experts"] // 2
        counts, layers = run["counts"], MOE_KW["num_layers"]
        assert "mlp_out" not in counts
        assert counts["moe_out"] == counts["attn_out"] \
            == layers * counts["tokens"]


@pytest.mark.parametrize("name", ["moe_tie_mixed", "moe_tie_split"])
def test_tp2_tp_in_expert_moe_matches_jax_tp1(family_runs, name):
    """TP inside each expert (``Strategy(expert_parallel=False)``) on the
    runs of ``test_tp2_moe_matches_jax_tp1``: all four experts and half of
    each expert's d_ff a rank (``w_up`` (L, 4, 64, 64)), the JAX engine's
    tp 1 streams and counters, one program shape, half the pool a rank;
    one ``moe_out`` sum a layer a program, of the gate-weighted (T, d)
    output: its bytes exactly 1/k of the expert-parallel run's (T k, d)
    slots on the same programs. Serving sums no gate."""
    want, jstats, jdev = _jax_family_run(name)
    ep = name.replace("_tie", "")
    k = MOE_KW["experts_per_token"]
    for r in family_runs:
        run = r[name]
        assert run["done"] and run["streams"] == want
        for key in COUNTERS:
            assert run["stats"][key] == jstats[key], key
        assert run["stats"]["decode_traces"] == 1
        assert run["per_device"] * 2 == jdev
        layers, d = MOE_KW["num_layers"], MOE_KW["d_model"]
        assert run["experts"] == MOE_KW["num_experts"]
        assert run["w_up"] == (layers, MOE_KW["num_experts"], d,
                               MOE_KW["d_ff"] // 2)
        counts = run["counts"]
        assert "mlp_out" not in counts and "moe_gate.grad" not in counts
        assert counts["moe_out"] == counts["attn_out"] \
            == layers * counts["tokens"] == r[ep]["counts"]["moe_out"]
        assert run["bytes"]["moe_out"] * k == r[ep]["bytes"]["moe_out"]


def test_tp2_moe_prefix_cache_lazy_matches_jax_tp1(family_runs):
    """Two slots with the prefix cache (the MoE whole-context salt) and
    lazy growth under tp 2: the JAX engine's streams and every prefix,
    preemption and CoW counter."""
    want, jstats, _ = _jax_family_run("moe_prefix")
    for r in family_runs:
        run = r["moe_prefix"]
        assert run["done"] and run["streams"] == want
        for key in COUNTERS:
            assert run["stats"][key] == jstats[key], key
    assert jstats["prefix_hit_blocks"] > 0


def test_tp2_moe_experts_kept_whole_reduce_nothing(family_runs):
    """E 3 does not divide tp 2: the table keeps all three experts on
    both ranks, each rank computes the whole FFN and no ``moe_out``
    all-reduce runs (a sum over the ranks would count each output twice);
    the JAX engine's streams."""
    want, _, _ = _jax_family_run("moe_e3")
    for r in family_runs:
        run = r["moe_e3"]
        assert run["done"] and run["streams"] == want
        assert run["experts"] == 3
        assert "moe_out" not in run["counts"]


@pytest.mark.parametrize("name", ["audio_mixed", "audio_split"])
def test_tp2_encdec_matches_jax_tp1(family_runs, name):
    """tests/test_serve_parallel.py:348's tp half on the mixed step and
    the split path: frames through the sharded encoder, the decoder pages
    and the cross K/V blocks sharded by head; the JAX engine's streams,
    program and encode shapes, half its decode state a rank; the encoder
    layer's two all-reduces at each admission and the decoder layer's
    three (self, cross, MLP) a program."""
    want, jstats, jdev = _jax_family_run(name)
    for r in family_runs:
        run = r[name]
        assert run["done"] and run["streams"] == want
        for key in ("decode_traces", "prefill_traces", "encode_traces",
                    "prefills", "decode_steps"):
            assert run["stats"][key] == jstats[key], key
        assert run["per_device"] * 2 == jdev
        counts = run["counts"]
        enc, dec = AUDIO_KW["encoder_layers"], AUDIO_KW["num_layers"]
        admissions, programs = run["stats"]["prefills"], counts["tokens"]
        assert counts["mlp_out"] == enc * admissions + dec * programs
        assert counts["attn_out"] == enc * admissions + 2 * dec * programs


# ------------------------------------------- the context-parallel decode

@pytest.mark.parametrize("prompt", [CP_PROMPT, CP_SHORT])
def test_tp2_cp_decode_matches_jax_cp_decode(spawned, prompt):
    """tests/test_cp_attention.py at mesh (1, 2): the port's lockstep CP
    decode on each rank equals JAX's CP ``decode_step`` under the same
    mesh within LOGITS_TOL and the JAX full forward within 5e-4; each
    rank's cache holds its 16 of the 32 positions, both K/V heads. After
    the 14-token prompt rank 1's slice is all masked for two steps (its
    partial weighs 0), then rank 1 owns the cursor at its first
    position."""
    for r in spawned[1]:
        check_cp_rank(r["cp"][prompt], (1, 2))


def test_tp2_cp_collective_volume_is_tiny(spawned):
    """tests/test_cp_attention.py:50 in the port, at B 8, S 64, tp 2 by
    ``Rank``'s byte tally: a CP decode step adds per layer one
    head-assembly sum of q and the new K/V row, one MAX of m and one SUM
    of (l, o), O(B Hq D) bytes and below one cache's B S Hkv D 4 bytes;
    no collective of the step carries a cache. The prefill assembles each
    layer's K/V (its heads are sharded: Hkv 2 over tp 2) by one sum."""
    cfg = _cp_cfg()
    b, hq, hkv, d, layers = (CP_VOL_B, cfg.num_heads, cfg.num_kv_heads,
                             cfg.head_dim, cfg.num_layers)
    cache_bytes = b * CP_VOL_S * hkv * d * 4
    want = {"cp_qkv": (b * hq * d + 2 * b * hkv * d) * 4,
            "cp_max": b * hq * 4, "cp_sum": b * hq * (d + 1) * 4}
    for r in spawned[1]:
        counts, nbytes = r["cp_extra"]["step"]
        for label, per_layer in want.items():
            assert counts[label] == layers
            assert nbytes[label] == layers * per_layer
        extra = sum(want.values())
        assert extra < cache_bytes and extra <= 4 * b * hq * (d + 1) * 4
        assert all(nbytes[k] / counts[k] < cache_bytes for k in counts)
        assert set(counts) == set(want) | {"embed", "attn_out", "mlp_out",
                                           "logits"}
        pcounts, pbytes = r["cp_extra"]["prefill"]
        assert pcounts["prefill_kv"] == layers
        assert pbytes["prefill_kv"] == layers * 2 * b * (CP_VOL_S - 4) \
            * hkv * d * 4


def test_tp2_greedy_generate_cp_matches_jax(spawned):
    """``greedy_generate`` under the tp 2 rank with ``cp_decode`` (the
    rank's cache rows, its prefill, CP decode steps, the root's token
    broadcast each step) gives JAX ``greedy_generate``'s streams on both
    ranks."""
    import jax.numpy as jnp
    from repro.core.strategy import Strategy as JaxStrategy
    from repro.serve.step import greedy_generate
    jcfg, jp, _ = _jax_cp_params()
    want = np.asarray(greedy_generate(
        jp, jcfg, JaxStrategy(), {"tokens": jnp.asarray(
            CP_TOKS[:, :CP_PROMPT])}, CP_S - CP_PROMPT))
    for r in spawned[1]:
        np.testing.assert_array_equal(r["cp_extra"]["greedy"], want)
        assert r["cp_extra"]["greedy_counts"]["tokens"] == CP_S - CP_PROMPT


# -------------------------------------- the SSM family and the hybrid

def _mamba_layers(kw):
    cfg = ModelConfig(**kw)
    if cfg.arch_type != "hybrid":
        return cfg.num_layers, 0
    g, _ = cfg.hybrid_groups
    return g * cfg.hybrid_attn_every, g


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_tp2_ssm_engine_matches_jax_tp1(family_runs, name):
    """tests/test_serve_engine.py::test_engine_ssm_matches_sequential's run
    (and the hybrid smoke's) under tp 2, a Mamba2 block split by whole
    heads: the JAX engine's streams and counters, one decode program
    shape; one ``ssm_out`` and one ``ssm_norm`` sum a Mamba layer a
    program (the hybrid: one ``attn_out`` and one ``mlp_out`` an
    application of the shared block) and no other collective in a
    layer."""
    want, jstats, _ = _jax_family_run(name)
    kw = FAMILY_RUNS[name][0]
    mamba, groups = _mamba_layers(kw)
    for run in family_runs:
        r = run[name]
        assert r["done"] and r["streams"] == want
        for key in COUNTERS:
            assert r["stats"][key] == jstats[key], key
        assert r["stats"]["decode_traces"] == 1
        programs = r["stats"]["prefills"] + r["stats"]["decode_steps"]
        counts = r["counts"]
        assert counts["ssm_out"] == counts["ssm_norm"] == mamba * programs
        assert counts.get("attn_out", 0) == counts.get("mlp_out", 0) == \
            groups * programs
        assert counts["embed"] == counts["logits"] == programs
        assert set(counts) <= {"ssm_out", "ssm_norm", "attn_out", "mlp_out",
                               "embed", "logits", "tokens", "clock",
                               "step_check"}, counts


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_tp2_ssm_engine_holds_half_the_states(family_runs, name):
    """Each rank's SSM states are its H / 2 heads: half the unsharded
    engine's state bytes; ``kv_bytes`` stays the unsharded engine's
    (the conv tails keep all of B and C on each rank, so a rank holds
    more than half of them)."""
    from repro_torch.params import init_params
    kw, _, _, _, ekw = FAMILY_RUNS[name]
    cfg = ModelConfig(**kw)
    one = ServeEngine(cfg, init_params(cfg, device="cpu", seed=0), **ekw)
    for run in family_runs:
        r = run[name]
        assert r["state_bytes"] * 2 == state_bytes(one)
        assert r["kv_bytes"] == one.kv_bytes()
        assert one.kv_bytes() / 2 < r["per_device"] < one.kv_bytes()


def test_tp2_hybrid_one_kv_head_decodes_context_parallel(family_runs):
    """The hybrid with one KV head under tp 2: the shared block's dense
    rows hold each rank's sequence slice with the one head (half the K/V
    a rank), every decode step's attention is context-parallel (one
    ``cp_qkv``, ``cp_max`` and ``cp_sum`` an application) and each
    prefill assembles no K/V heads (both ranks compute the one head);
    the JAX engine's streams."""
    want, jstats, _ = _jax_family_run("hybrid_kv1")
    kw = FAMILY_RUNS["hybrid_kv1"][0]
    _, groups = _mamba_layers(kw)
    for run in family_runs:
        r = run["hybrid_kv1"]
        assert r["done"] and r["streams"] == want
        for key in COUNTERS:
            assert r["stats"][key] == jstats[key], key
        steps = r["stats"]["decode_steps"]
        c = r["counts"]
        assert {k: c[k] for k in ("cp_qkv", "cp_max", "cp_sum")} == \
            dict.fromkeys(("cp_qkv", "cp_max", "cp_sum"), groups * steps)
        assert "prefill_kv" not in c


def test_tp2_encdec_one_kv_head_holds_sequence_slices(family_runs):
    """The enc-dec config with one KV head under tp 2 on the split path's
    dense rows (the twin of the hybrid's case): each rank's ``kv`` and
    ``xkv`` hold half the positions (its slice, ``kv_slice`` /
    ``xkv_slice``) with the one head, as the reference's ``cache_pspecs``
    shards them; every decode step attends context-parallel (a layer:
    one ``cp_qkv`` and one ``cp_xq`` sum, two ``cp_max`` and two
    ``cp_sum``), no prefill sends K/V heads; the JAX engine's unsharded
    f32 streams and counters."""
    want, jstats, jdev = _jax_family_run("audio_kv1_dense")
    kw = FAMILY_RUNS["audio_kv1_dense"][0]
    layers, ctx = kw["num_layers"], kw["encoder_ctx"]
    for i, run in enumerate(family_runs):
        r = run["audio_kv1_dense"]
        assert r["done"] and r["streams"] == want
        for key in ("decode_traces", "prefill_traces", "prefills",
                    "decode_steps"):
            assert r["stats"][key] == jstats[key], key
        assert r["slices"] == {"kv_slice": (16 * i, 16, 32),
                               "xkv_slice": (ctx // 2 * i, ctx // 2, ctx)}
        assert r["kv_shapes"] == {"kv": (layers, 2, 16, 1, 16),
                                  "xkv": (layers, 2, ctx // 2, 1, 16)}
        assert r["per_device"] * 2 == jdev
        steps = r["stats"]["decode_steps"]
        c = r["counts"]
        assert c["cp_qkv"] == c["cp_xq"] == layers * steps
        assert c["cp_max"] == c["cp_sum"] == 2 * layers * steps
        assert "prefill_kv" not in c


# ------------------------------------------------------------------ the VLM

def _vlm_layers(kw):
    """(self layers, cross layers) a VLM program applies."""
    cfg = ModelConfig(**kw)
    g, rest = cfg.vlm_groups
    return g * cfg.cross_attn_every + rest, g


def test_tp2_vlm_matches_jax_tp1(family_runs):
    """tests/test_serve_vlm.py's config (gates open, each request with its
    images) under tp 2 on the split path's dense rows: the JAX engine's
    unsharded f32 streams and counters, one decode program shape, half
    its decode state a rank (the self rows and image K/V of one of the
    two K/V heads); every program's self and cross layers end in one
    ``attn_out`` and one ``mlp_out`` sum each, and nothing attends
    context-parallel."""
    want, jstats, jdev = _jax_family_run("vlm")
    selfs, cross = _vlm_layers(VLM_KW)
    for run in family_runs:
        r = run["vlm"]
        assert r["done"] and r["streams"] == want
        for key in COUNTERS:
            assert r["stats"][key] == jstats[key], key
        assert r["stats"]["decode_traces"] == 1
        assert r["per_device"] * 2 == jdev and r["slices"] == {}
        assert r["kv_shapes"] == {"kv_g": (2, 2, 32, 1, 16),
                                  "xkv": (1, 2, 8, 1, 16)}
        programs = r["stats"]["prefills"] + r["stats"]["decode_steps"]
        c = r["counts"]
        assert c["attn_out"] == c["mlp_out"] == (selfs + cross) * programs
        assert c["embed"] == c["logits"] == programs
        assert not {"cp_qkv", "cp_xq", "prefill_kv"} & set(c)


def test_tp2_vlm_one_kv_head_holds_sequence_slices(family_runs):
    """The VLM with one KV head under tp 2: each rank's self rows and
    image K/V hold half the positions (``kv_slice`` / ``xkv_slice``) with
    the one head, as the reference's ``cache_pspecs`` shards them; every
    decode step attends context-parallel (a self layer: one ``cp_qkv``,
    a cross layer: one ``cp_xq``; one ``cp_max`` and one ``cp_sum``
    each), no prefill sends K/V heads; the JAX engine's unsharded f32
    streams and counters."""
    want, jstats, jdev = _jax_family_run("vlm_kv1")
    selfs, cross = _vlm_layers(VLM_KV1_KW)
    n = VLM_KV1_KW["num_image_tokens"]
    for i, run in enumerate(family_runs):
        r = run["vlm_kv1"]
        assert r["done"] and r["streams"] == want
        for key in COUNTERS:
            assert r["stats"][key] == jstats[key], key
        assert r["slices"] == {"kv_slice": (16 * i, 16, 32),
                               "xkv_slice": (n // 2 * i, n // 2, n)}
        assert r["kv_shapes"] == {"kv_g": (2, 2, 16, 1, 16),
                                  "xkv": (1, 2, n // 2, 1, 16)}
        assert r["per_device"] * 2 == jdev
        steps = r["stats"]["decode_steps"]
        c = r["counts"]
        assert c["cp_qkv"] == selfs * steps and c["cp_xq"] == cross * steps
        assert c["cp_max"] == c["cp_sum"] == (selfs + cross) * steps
        assert "prefill_kv" not in c


def test_tp2_vlm_cp_decode_matches_jax_cp_decode(spawned):
    """The VLM's lockstep decode with ``cp_decode`` at a scalar ``pos``
    under tp 2 (the reference's ``use_cp`` branch): a 12-token prefill
    with images and four steps, logits within 1e-5 of JAX's CP
    ``decode_step`` under a (1, 2) mesh on both ranks; each rank's self
    rows hold its 8 of the 16 positions with both K/V heads, its image
    K/V its one head (Hkv 2 divides tp 2)."""
    want = jax_vlm_cp()
    for r in spawned[1]:
        got = r["vlm_cp"]
        for i, pos in enumerate(range(VLM_CP_PROMPT, VLM_CP_S)):
            np.testing.assert_allclose(got["logits"][i], want[i],
                                       atol=VLM_CP_TOL, rtol=0,
                                       err_msg=str(pos))
        i = got["model_rank"]
        assert got["slice"] == (8 * i, 8, 16) and not got["xkv_slice"]
        assert got["shapes"] == {"kv_g": (2, 2, 8, 2, 16),
                                 "kv_t": (1, 2, 8, 2, 16),
                                 "xkv": (1, 2, 8, 1, 16)}


def test_tp2_vlm_decode_collectives_by_label(spawned):
    """A VLM decode step under tp 2 issues one ``attn_out`` and one
    ``mlp_out`` sum a self layer and a cross layer, one for the
    embedding and one for the logits; on the CP rows each self layer adds
    its head assembly, MAX and SUM — nothing else. The prefill assembles
    each self layer's K/V heads once (``prefill_kv``: the rank computed
    its one head of two)."""
    selfs, cross = _vlm_layers(VLM_KW)
    for r in spawned[1]:
        prefill, step = r["vlm_cp"]["counts"]
        assert step == {"attn_out": selfs + cross, "mlp_out": selfs + cross,
                        "embed": 1, "logits": 1, "cp_qkv": selfs,
                        "cp_max": selfs, "cp_sum": selfs}
        assert prefill == {"attn_out": selfs + cross,
                           "mlp_out": selfs + cross, "embed": 1,
                           "logits": 1, "prefill_kv": selfs}


def test_tp2_ssm_decode_logits_and_states_match_jax(spawned):
    """tests/test_parallel_equivalence.py::test_decode_sharded_equals_
    reference on (1, 2) for the mamba2 and zamba2 smokes, and a prefill
    and decode steps after it: logits within its 5e-4, the states and
    conv tails the JAX ones of the rank's heads (``check_ssm_model_
    rank``)."""
    for r in spawned[1]:
        check_ssm_model_rank(r["ssm"])
    assert sorted(r["ssm"]["mamba2-780m"]["model_rank"]
                  for r in spawned[1]) == [0, 1]


# ------------------------------------------- the online driver over ranks

@pytest.fixture(scope="module")
def online(spawned):
    """Both ranks' online cases; the ranks' engines must have run the same
    programs (equal counters and collectives) in every case but the
    deliberate divergence."""
    ranks = [r["online"] for r in spawned[1]]
    for name in ("deferred", "live", "deadline", "watchdog", "stop",
                 "http"):
        assert ranks[1][name]["stats"] == ranks[0][name]["stats"], name
        assert ranks[1][name]["counts"] == ranks[0][name]["counts"], name
    return ranks


def test_online_tp2_deferred_start_matches_jax_run(online):
    """tests/test_serve_online.py::test_stream_matches_run_tp2 on two
    ranks: rank 0 submits five requests before the loop starts, every
    rank starts its driver; rank 0's streams equal the JAX engine's batch
    ``run()`` token for token (and their records), one program shape on
    every rank, a TTFT a request on rank 0, no record left behind. A
    follower's ``submit`` raises naming rank 0; the control channel is
    two broadcasts a pass."""
    want = jax_online("deferred")
    lead, follower = online[0]["deferred"], online[1]["deferred"]
    assert lead["lead"] and not follower["lead"]
    assert lead["done"] and lead["streams"] == want
    assert lead["records"] == want
    assert lead["ttft"] == len(want) and follower["ttft"] == 0
    for r in (lead, follower):
        assert r["stats"]["decode_traces"] == 1
        assert r["counts"]["driver_events"] == 2 * r["passes"]
        assert r["left"] == (0, 0)
    assert "rank 0" in follower["refused"]


def test_online_tp2_live_submission_matches_jax_run(online):
    """tests/test_serve_online.py::test_live_submit_while_running over
    ``Session.serve_async(tp=2)``: requests submitted on rank 0 while the
    loop already steps finish with the JAX batch's streams."""
    assert online[0]["live"]["streams"] == jax_online("live")
    assert online[0]["live"]["stats"]["decode_traces"] == 1


def test_online_tp2_deadline_expires_while_queued(online):
    """A request whose deadline passes while two others hold both slots
    closes ``done=False, expired=True`` with no tokens; every rank's
    engine expired it at the same step (the counters above are equal and
    the later programs' checksums passed), and the two others stream the
    JAX batch's tokens."""
    got = online[0]["deadline"]["streams"]
    want = jax_online("deadline")
    assert {i: got[i] for i in want} == want
    assert got["late"] == ([], False, True)
    assert online[0]["deadline"]["expired"] == 1
    for r in online:
        assert r["deadline"]["stats"]["expired"] == 1


def test_online_tp2_watchdog_requeues_on_every_rank(online):
    """tests/test_serve_online.py::test_watchdog_detects_injected_stall
    over two ranks: a stall on rank 0 only fires rank 0's watchdog (a
    follower runs none); the requeue reaches every rank in the next
    batch, both preempt the active slot, and the stream still equals the
    JAX batch's. The abort is cleared after the recovery."""
    lead, follower = online[0]["watchdog"], online[1]["watchdog"]
    assert lead["out"] == (jax_online("watchdog")[0], True)
    assert lead["fired"] >= 1 and follower["fired"] == 0
    for r in (lead, follower):
        assert r["requeued"] >= 1
        assert r["stats"]["preemptions"] >= 1
        assert not r["abort"]
        assert "requeued 1 active request(s)" in r["log"]
    assert "stalled" in lead["log"] and "slot r0/s" in lead["log"]


def test_online_tp2_stop_without_drain_returns_partial(online):
    """``stop(drain=False)`` on rank 0 after two tokens: every rank's loop
    ends (a follower's at rank 0's "stop"), the records are partial
    (``done=False``, fewer than 40 tokens) and each is a prefix of the
    JAX batch's stream."""
    got = online[0]["stop"]["streams"]
    want = jax_online("stop")
    assert got["first"] == want[0][:2]
    for rid, stream in want.items():
        out, done = got[rid]
        assert not done and len(out) < len(stream)
        assert out == stream[:len(out)]
    for r in online:
        assert r["stop"]["ended"] and r["stop"]["error"] == "None"


def test_online_tp2_http_on_rank_0(online):
    """tests/test_serve_online.py::test_http_endpoints_over_socket over
    ``Session.serve_http(tp=2)``: only rank 0 binds a port; /generate as
    JSON and chunked returns the JAX batch's tokens; /metrics and
    /healthz answer while the loop idles. No HTTP thread issued a
    collective: both ranks' collectives are equal in number and kind."""
    want = jax_online("http")
    lead, follower = online[0]["http"], online[1]["http"]
    assert lead["url"].startswith("http://") and follower["url"] is None
    assert lead["json"]["done"] is True and lead["json"]["tokens"] == want[0]
    assert lead["chunked"] == "chunked"
    *toks, closing = lead["lines"]
    assert [ln["token"] for ln in toks] == want[1]
    assert closing["done"] is True and closing["tokens"] == want[1]
    metrics = lead["metrics"]
    assert "serve_ttft_seconds_count 2" in metrics
    assert "serve_requests_completed_total 2.0" in metrics
    assert "serve_engine_pages_in_use" in metrics
    assert lead["health"]["status"] == "ok"
    assert lead["health"]["step_count"] > 0
    assert lead["health"]["busy"] is False


def test_online_tp2_divergence_raises_on_every_rank(online):
    """A fault hands the follower a batch with another prompt: the
    engines' checksum before the first program raises on both ranks, both
    loops end (no hang) and rank 0's stream closes unfinished."""
    for r in online:
        assert "packed different programs" in r["diverged"]["error"]
        assert r["diverged"]["ended"]
    assert online[0]["diverged"]["done"] is False


# ------------------------------------------------- planner Plans, served

def test_plan_materializes_on_two_ranks(spawned):
    """``Plan.materialize`` over the ranks of the process group: the
    reference's refusals (degrees that do not tile the world or the
    devices asked for, more devices than ranks, ep not sharing the model
    axis); a (1, 2) ("data", "model") mesh, a (1, 2, 1) ("data", "pipe",
    "model") mesh for pp 2, a (2, 1) one for dp 2, each rank at its own
    coordinate; the strategy's fields from the degrees, named
    ``plan/<method>``, with the overrides."""
    for rank, r in enumerate(spawned[1]):
        got = r["plan"]
        for key in ("tile", "tile 1"):
            assert "do not tile" in got["refused"][key], key
        assert "but only 2 are available" in got["refused"]["available"]
        assert "must share the model axis" in got["refused"]["ep"]
        axes, coord, st = got["layouts"]["model"]
        assert axes == {"data": 1, "model": 2}
        assert coord == {"data": 0, "model": rank}
        assert st.seq_parallel and not st.remat and st.microbatches == 2
        assert st.name == "plan/manual" and st.dtype == "float32"
        axes, coord, st = got["layouts"]["pipe"]
        assert axes == {"data": 1, "pipe": 2, "model": 1}
        assert coord == {"data": 0, "pipe": rank, "model": 0}
        assert st.microbatches == 4 and not st.seq_parallel
        axes, coord, st = got["layouts"]["data"]
        assert axes == {"data": 2, "model": 1}
        assert coord == {"data": rank, "model": 0}
        assert st.fsdp and not st.zero1


@pytest.mark.parametrize("mixed", [True, False])
def test_tp2_dp_plan_serves_jax_plan_streams(spawned, mixed):
    """``Session.from_plan`` of the "dp" search's 2-chip plan (dp 1 x tp
    2 with ``seq_parallel``, the reference's plan field for field) on
    JAX's weights: ``serve()`` (``mixed=False``: the split path) builds
    the tp 2 engine on the session's own mesh and gives the streams of
    JAX's ``Session.from_plan(..., devices=2).serve()`` on every rank."""
    row, want = _jax_plan_serve(mixed)
    for r in spawned[1]:
        got = r["plan"]
        assert got["row"] == row
        assert row["degrees"]["tp"] == 2 and row["degrees"]["dp"] == 1
        assert row["degrees"]["seq_parallel"] and got["strategy"].seq_parallel
        streams, tp_n, eng_mixed, same_mesh = got[mixed]
        assert streams == want
        assert tp_n == 2 and eng_mixed == mixed and same_mesh
