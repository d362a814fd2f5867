"""Data-parallel replica routing in the port (serve/parallel.py), on the
CPU: the twin of tests/test_serve_parallel.py's dp cases and routing
policy.

In one process (tp 1) the port's ``ReplicaRouter`` holds both replicas,
here on the one CPU device twice (``devices=["cpu"] * 2``): its streams
are held to the JAX single engine's on the same weights, its routing
decisions to the JAX ``ReplicaRouter``'s (``replica_of``) on the same
submissions — least load, prefix affinity and its give-way, and the
latency-aware ``load / rate`` route with the EWMAs set by hand — and
``Session.serve(dp=2)`` and ``launch/serve.py --dp 2`` to the single
engine. The JAX router builds its replicas on conftest's 8 host devices.

The dp 2 x tp 2 topology runs in one spawn of four rank processes
(``launch/ranks.py``: gloo, a FileStore under ``tmp_path``, a timeout
that kills the ranks), each serving its row's tp 2 replica: the union of
the streams on every rank equals the JAX single engine's, one program
shape a replica, half the KV a rank, the replicas' ranks disjoint; the
same with speculative decode, through ``Session.serve(dp=2, tp=2)``, and
through ``launch/serve.py --dp 2 --tp 2``. The same four ranks run the
context-parallel lockstep decode of tests/test_cp_attention.py on
meshes (1, 4) and (2, 2) (tests/test_torch_tp.py's ``cp_rank``; at (2,
2) each data row of ranks takes its 2 batch rows), held to JAX's CP
``decode_step`` under the same mesh and to the JAX full forward. They
also serve tests/test_serve_online.py's dp 2 case online: the driver on
every rank over a dp 2 x tp 2 router, rank 0 taking the requests, its
streams held to the JAX engine's batch and its routing to the lockstep
router's. The SSM family serves there too (tests/test_serve_engine.py's
``SSM_CFG`` over the dp 2 x tp 2 router, a Mamba2 block split by whole
heads: the JAX engine's batch streams), and so does the MoE with TP
inside each expert (tests/test_torch_tp.py's ``MOE_KW`` with
``Strategy(expert_parallel=False)``, one slot a replica: the JAX
engine's streams of its ``moe_mixed`` run), and the lockstep SSM and hybrid
decode of tests/test_torch_tp.py's ``ssm_model_rank`` runs on (1, 4):
the reference's ``test_decode_sharded_equals_reference`` logits within
5e-4, the states of the rank's one head. A planner Plan of dp 2 x tp 2
with ``fsdp`` and ``seq_parallel`` serves there through
``Session.from_plan(...).serve()``: the router over the plan's mesh,
the streams, routing and collectives of the router without the flags.
The same ranks serve on the ("pod", "data", "model") meshes (2, 1, 2)
and (1, 2, 2), a replica a (pod, data) coordinate: the engine serving
its row alone and the dp 2 x tp 2 router over the mesh give the
reference engine's streams on the same mesh, the router the JAX dp 2
router's routing. And the VLM (tests/test_serve_vlm.py's config, gates
open) serves behind the dp 2 x tp 2 router, each request with its
images, built by hand and through ``Session.serve(dp=2, tp=2)``: the
JAX VLM engine's batch streams, both replicas serving.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Session  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.serve.parallel import (ReplicaRouter,  # noqa: E402
                                        replica_meshes)
from test_torch_tp import (FAMILY_RUNS, MOE_KW, ONLINE_ENG,  # noqa: E402
                           ONLINE_KW, ONLINE_RUNS, SSM_KW, TIE, VLM_KW,
                           _flat, _jax_cp_params, _jax_family_run,
                           check_cp_rank, check_ssm_model_rank, cp_rank,
                           jax_online, ssm_flats, ssm_model_rank)

#: the context-parallel decode's meshes on the four ranks
CP_MESHES = ((1, 4), (2, 2))
#: the ("pod", "data", "model") meshes the four ranks serve on
POD_MESHES = ((2, 1, 2), (1, 2, 2))

RANK_TIMEOUT = 120.0            # seconds the spawn may take before it fails

#: tests/test_serve_parallel.py's CFG and AUDIO_CFG
KW = dict(name="par-dense", arch_type="dense", num_layers=2, d_model=128,
          num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=128,
          dtype="float32")
AUDIO_KW = dict(name="par-encdec", arch_type="audio", num_layers=2,
                d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
                vocab_size=128, encoder_layers=1, encoder_ctx=12,
                dtype="float32")
SEEDS = {"par-dense": 0, "par-encdec": 2, "online-dense": 0,
         "engine-ssm": 4}
#: tests/test_serve_engine.py::test_engine_ssm_matches_sequential's engine
SSM_ENG = dict(slots=2, max_len=64)
ENG = dict(slots=2, max_len=64, paged=True)
CPU2 = ["cpu"] * 2

_JAX = {}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These shapes are tiny: one intra-op thread computes them as fast,
    and the test workers running beside this one keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(kw):
    """(JAX config, JAX params at the reference test's seed, their
    bridge into the port on the CPU), made once a config."""
    if kw["name"] not in _JAX:
        import jax
        from repro.checkpoint.io import _flatten
        from repro.configs.base import ModelConfig as JaxConfig
        from repro.models import get_model
        jcfg = JaxConfig(**kw)
        jp = jax.jit(get_model(jcfg).init, static_argnums=1)(
            jax.random.key(SEEDS[kw["name"]]), jcfg)
        flat = {k: np.asarray(v) for k, v in _flatten(jp).items()}
        _JAX[kw["name"]] = (jcfg, jp, flat)
    jcfg, jp, flat = _JAX[kw["name"]]
    return jcfg, jp, from_numpy(flat, ModelConfig(**kw), "cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=(n,)).astype(np.int32) for n in lens]


def _jax_streams(kw, prompts, new, frames=None, **ekw):
    """The JAX single engine's streams, made once a case."""
    key = (kw["name"], tuple(map(tuple, prompts)), new,
           tuple(sorted(ekw.items())))
    if key not in _JAX:
        from repro.serve.engine import ServeEngine as JaxEngine
        jcfg, jp, _ = _jax_params(kw)
        eng = JaxEngine(jcfg, jp, **ekw)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=new,
                       frames=None if frames is None else frames[i])
        res = eng.run()
        _JAX[key] = {i: list(res[i].out) for i in res}
    return _JAX[key]


def _jax_pod_streams(shape, prompts, new):
    """The reference engine's streams on a ("pod", "data", "model") mesh
    of ``shape`` over the first of conftest's 8 host devices (one GSPMD
    engine, the batch over "pod" x "data"), made once a mesh."""
    key = ("pod", shape, tuple(map(tuple, prompts)), new)
    if key not in _JAX:
        import jax
        from repro.launch.mesh import make_mesh
        from repro.serve.engine import ServeEngine as JaxEngine
        jcfg, jp, _ = _jax_params(KW)
        mesh = make_mesh(shape, ("pod", "data", "model"),
                         devices=jax.devices()[:int(np.prod(shape))])
        eng = JaxEngine(jcfg, jp, mesh=mesh, **ENG)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=new)
        res = eng.run()
        _JAX[key] = {i: list(res[i].out) for i in res}
    return _JAX[key]


def _jax_router(kw, **ekw):
    from repro.serve.parallel import ReplicaRouter as JaxRouter
    jcfg, jp, _ = _jax_params(kw)
    return JaxRouter(jcfg, jp, dp=2, **ekw)


def _run(router, prompts, new):
    homes = [router.submit(i, p, max_new=new) for i, p in enumerate(prompts)]
    res = router.run()
    return homes, {i: list(res[i].out) for i in res}, res


# ------------------------------------------------------- one process

def test_dp2_router_matches_single_engine():
    """tests/test_serve_parallel.py:403: the dp 2 router's streams equal
    the JAX single engine's, every request done, both replicas prefill,
    one program shape each, and every request on the replica the JAX
    router puts it on."""
    prompts = _prompts(1, (5, 7, 6, 8, 5, 7))
    want = _jax_streams(KW, prompts, 6, **ENG)
    router = ReplicaRouter(ModelConfig(**KW), _jax_params(KW)[2],
                           dp=2, devices=CPU2, **ENG)
    homes, got, res = _run(router, prompts, 6)
    assert got == want
    assert all(r.done for r in res.values())
    st = router.stats
    assert [r["decode_traces"] for r in st["replicas"]] == [1, 1]
    assert all(r["prefills"] > 0 for r in st["replicas"])
    jr = _jax_router(KW, **ENG)
    assert homes == [jr.submit(i, p, max_new=6)
                     for i, p in enumerate(prompts)]
    # one process, one card: the replicas share one set of weights
    assert router.engines[0].params["embed"].data_ptr() == \
        router.engines[1].params["embed"].data_ptr()
    assert router.kv_bytes() == 2 * router.engines[0].kv_bytes()


def test_router_least_load_matches_jax_router():
    """tests/test_serve_parallel.py:446: without a prefix cache the
    submissions alternate (least load, the lowest index on ties) as the
    JAX router's do; a rid submitted twice raises its text."""
    params = _jax_params(KW)[2]
    router = ReplicaRouter(ModelConfig(**KW), params, dp=2, devices=CPU2,
                           **ENG)
    jr = _jax_router(KW, **ENG)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, size=(6,)) for _ in range(6)]
    homes = [router.submit(i, p, max_new=4) for i, p in enumerate(prompts)]
    assert homes == [jr.submit(i, p, max_new=4)
                     for i, p in enumerate(prompts)] == [0, 1, 0, 1, 0, 1]
    assert router.replica_of(3) == jr.replica_of(3) == 1
    with pytest.raises(ValueError, match="already submitted"):
        router.submit(3, prompts[0], max_new=4)


def test_router_prefix_affinity_matches_jax_router():
    """tests/test_serve_parallel.py:462: prompts sharing a first block go
    to the replica that took it while it is within ``slots`` of the least
    loaded one, then give way — on the same replicas as the JAX router's;
    a prompt without a full block keys nothing."""
    params = _jax_params(KW)[2]
    kw = dict(slots=1, max_len=64, paged=True, prefix_cache=True)
    router = ReplicaRouter(ModelConfig(**KW), params, dp=2, devices=CPU2,
                           **kw)
    jr = _jax_router(KW, **kw)
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 128, size=(16,))
    mk = lambda: np.concatenate(  # noqa: E731
        [shared, rng.integers(0, 128, size=(4,))]).astype(np.int32)
    prompts = [mk(), rng.integers(0, 128, size=(6,)).astype(np.int32),
               mk(), mk()]
    homes = [router.submit(i, p, max_new=4) for i, p in enumerate(prompts)]
    assert homes == [jr.submit(i, p, max_new=4)
                     for i, p in enumerate(prompts)] == [0, 1, 0, 0]
    tail = mk()
    assert router.route(tail) == jr.route(tail) == 1     # the give-way
    assert router._affinity_key(np.arange(3)) is None


def test_router_latency_aware_route_matches_jax_router():
    """tests/test_serve_online.py:268 on both routers, the EWMAs set by
    hand: least load while a replica is cold, then ``load / rate``."""
    params = _jax_params(KW)[2]
    kw = dict(slots=1, max_len=64, paged=True)
    router = ReplicaRouter(ModelConfig(**KW), params, dp=2, devices=CPU2,
                           **kw)
    jr = _jax_router(KW, **kw)
    p = np.arange(5, dtype=np.int32)
    picks = []
    for rt in (router, jr):
        got = [rt.route(p)]
        rt.engines[0].stats["tokens_per_s_ewma"] = 10.0
        got.append(rt.route(p))
        rt.engines[1].stats["tokens_per_s_ewma"] = 40.0
        rt.engines[0].submit(0, p, max_new=4)
        rt.engines[1].submit(1, p, max_new=4)
        got.append(rt.route(p))
        # a slower replica 1 at equal load loses it
        rt.engines[1].stats["tokens_per_s_ewma"] = 5.0
        got.append(rt.route(p))
        picks.append(got)
    assert picks[0] == picks[1] == [0, 0, 1, 0]


def test_replica_meshes_validation():
    """tests/test_serve_parallel.py:486: too few devices and degrees
    below 1 raise the reference's texts; a list of 4 gives two slices of
    2 devices, ("data", "model") = (1, 2) each; a repeated device
    counts once a slot."""
    with pytest.raises(ValueError, match="devices needed"):
        replica_meshes(4, 4, ["cpu"] * 8)
    with pytest.raises(ValueError, match="devices needed"):
        replica_meshes(2, 1, device_type="cpu")
    with pytest.raises(ValueError, match="must be >= 1"):
        replica_meshes(0, 2)
    meshes = replica_meshes(2, 2, ["cpu"] * 4)
    assert len(meshes) == 2
    assert all(m.shape == {"data": 1, "model": 2} for m in meshes)
    assert all(d.type == "cpu" for m in meshes for d in m.devices)


def test_dp2_encdec_router_with_frames_matches_single_engine():
    """tests/test_serve_parallel.py:368, the router half: an enc-dec dp 2
    router, each request with its frames, streams the JAX single
    engine's, one program and one encode shape a replica."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, size=(n,)).astype(np.int32)
               for n in (4, 7, 5)]
    frames = [rng.standard_normal((12, 64)).astype(np.float32)
              for _ in prompts]
    kw = dict(slots=2, max_len=32, paged=True)
    want = _jax_streams(AUDIO_KW, prompts, 5, frames=frames, **kw)
    router = ReplicaRouter(ModelConfig(**AUDIO_KW), _jax_params(AUDIO_KW)[2],
                           dp=2, devices=CPU2, **kw)
    for i, (p, f) in enumerate(zip(prompts, frames)):
        router.submit(i, p, max_new=5, frames=f)
    res = router.run()
    assert {i: list(res[i].out) for i in res} == want
    assert all(r["decode_traces"] == 1 and r["encode_traces"] == 1
               for r in router.stats["replicas"])
    with pytest.raises(ValueError, match="enc-dec"):
        router.submit(9, prompts[0], max_new=5)
    assert router.replica_of(9) is None


def test_session_serve_dp2_matches_plain():
    """``Session.serve(dp=2, devices=)`` is a router whose streams equal
    ``Session.serve()``'s on the same session; without devices the one
    CPU device is too few; ``devices=`` on one engine is refused."""
    cfg = ModelConfig(**KW)
    session = Session(cfg, device="cpu", seed=3)
    prompts = _prompts(3, (5, 7, 6))
    plain = session.serve(slots=2, max_len=64)
    router = session.serve(dp=2, devices=CPU2, slots=2, max_len=64)
    assert isinstance(router, ReplicaRouter) and router.dp == 2
    assert isinstance(plain, ServeEngine)
    for i, p in enumerate(prompts):
        plain.submit(i, p, max_new=6)
        router.submit(i, p, max_new=6)
    a, b = plain.run(), router.run()
    assert {i: a[i].out for i in a} == {i: b[i].out for i in b}
    with pytest.raises(ValueError, match="devices needed"):
        session.serve(dp=2)
    with pytest.raises(ValueError, match="devices="):
        session.serve(devices=CPU2)


def test_launch_serve_dp2_on_the_cpu(capsys):
    """``launch/serve.py --device cpu --dp 2``: both replicas on the CPU,
    the streams of ``--dp 1``, the summed report with the worst replica's
    program shapes."""
    from repro_torch.launch.serve import main
    argv = ["--device", "cpu", "--requests", "4", "--max-new", "4"]
    one = main(argv)
    two = main(argv + ["--dp", "2"])
    assert {r: v.out for r, v in one.items()} == \
        {r: v.out for r, v in two.items()}
    text = capsys.readouterr().out
    assert "dp 2, requests a replica [2, 2]" in text
    assert "1 decode shapes" in text


# --------------------------------------------- dp 2 x tp 2, four ranks

def _online_router_rank(flat):
    """The online driver on this rank over a dp 2 x tp 2 router
    (deferred start, rank 0 submits), after the same submissions through
    the lockstep router: each one's replicas, rank 0's streams, and the
    collectives."""
    from repro_torch.serve.driver import AsyncDriver
    cfg = ModelConfig(**ONLINE_KW)
    params = from_numpy(flat, cfg, "cpu")
    prompts, new = ONLINE_RUNS["router"]
    lockstep = _run(ReplicaRouter(cfg, params, dp=2, tp=2, **ONLINE_ENG),
                    prompts, new)[0]
    router = ReplicaRouter(cfg, params, dp=2, tp=2, **ONLINE_ENG)
    homes, submit = [], router.submit

    def routed(*args, **kw):
        homes.append(submit(*args, **kw))
        return homes[-1]

    router.submit = routed
    drv = AsyncDriver(router, start=False)
    live = [drv.submit(p, max_new=new, rid=i)
            for i, p in enumerate(prompts)] if drv.lead else []
    drv.start()
    streams = {s.rid: s.tokens() for s in live}
    done = all(s.result(timeout=60.0).done for s in live)
    drv.stop()
    return {"lead": drv.lead, "streams": streams, "done": done,
            "homes": homes, "lockstep": lockstep,
            "ttft": drv.metrics.ttft.count,
            "counts": dict(router.engines[0]._rank.counts),
            "left": (len(router._home), len(router.engines[0].finished))}


def _pod_rank(cfg, params, prompts):
    """This rank's engine and router on each of ``POD_MESHES``: the
    engine serving its ("pod", "data") row alone (every request), then
    the dp 2 x tp 2 router over the same mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    out = {}
    for shape in POD_MESHES:
        mesh = make_mesh(shape, ("pod", "data", "model"), device_type="cpu")
        eng = ServeEngine(cfg, params, mesh=mesh, **ENG)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=6)
        alone = {i: list(r.out) for i, r in eng.run().items()}
        router = ReplicaRouter(cfg, params, dp=2, tp=2, mesh=mesh, **ENG)
        homes, streams, res = _run(router, prompts, 6)
        r = router.engines[0]._rank
        out[shape] = {"engine": alone, "engine_root": eng._rank.root,
                      "homes": homes, "streams": streams,
                      "done": all(q.done for q in res.values()),
                      "row": router.row, "rows": router.meshes,
                      "coord": (r.pod_rank, r.data_rank),
                      "group": dist.get_process_group_ranks(
                          mesh.get_group("model")), "root": r.root,
                      "traces": [x["decode_traces"]
                                 for x in router.stats["replicas"]],
                      "counts": dict(r.counts)}
    return out


def _vlm_router_rank(flat):
    """The VLM behind the dp 2 x tp 2 router, each request with its
    images: built by hand, and through ``Session.serve(dp=2, tp=2)`` of a
    session holding the same weights."""
    cfg = ModelConfig(**VLM_KW)
    params = from_numpy(flat, cfg, "cpu")
    _, prompts, images, new, ekw = FAMILY_RUNS["vlm"]
    out = {}
    for name in ("router", "session"):
        router = ReplicaRouter(cfg, params, dp=2, tp=2, **ekw) \
            if name == "router" else \
            Session(cfg, device="cpu", params=params).serve(dp=2, tp=2,
                                                            **ekw)
        homes = [router.submit(i, p, max_new=new, images=images[i])
                 for i, p in enumerate(prompts)]
        res = router.run()
        eng = router.engines[0]
        out[name] = {"homes": homes,
                     "streams": {i: list(r.out) for i, r in res.items()},
                     "done": all(r.done for r in res.values()),
                     "traces": [x["decode_traces"]
                                for x in router.stats["replicas"]],
                     "heads": (eng._rank.heads, eng._rank.kv_heads),
                     "counts": dict(eng._rank.counts)}
    return out


def _topology_rank(rank, world, flat, prompts, spec_prompts, cp_flat,
                   online_flat, ssm, moe_flat, vlm_flat):
    """One rank of the dp 2 x tp 2 runs: the router over a (2, 2) mesh
    on the engine keywords of the reference's test, with spec on, through
    ``Session.serve(dp=2, tp=2)`` and through the launcher; then the CP
    decode on each of ``CP_MESHES``, the online router, the SSM router,
    the TP-in-expert MoE router, the engine and the router on each of
    ``POD_MESHES`` and the VLM router."""
    import torch.distributed as dist
    from repro_torch.launch.serve import main
    from repro_torch.serve.speculative import SpecConfig
    torch.set_num_threads(1)
    cfg = ModelConfig(**KW)
    params = from_numpy(flat, cfg, "cpu")
    out = {}
    for name, ps, ekw in (
            ("plain", prompts, ENG),
            ("spec", spec_prompts, dict(ENG, chunk_tokens=16,
                                        spec=SpecConfig(k=4)))):
        router = ReplicaRouter(cfg, params, dp=2, tp=2, **ekw)
        homes, streams, res = _run(router, ps, 6)
        st = router.stats
        out[name] = {"homes": homes, "streams": streams,
                     "done": all(r.done for r in res.values()),
                     "row": router.row, "rows": router.meshes,
                     "group": dist.get_process_group_ranks(
                         router.mesh.get_group("model")),
                     "root": router.engines[0]._rank.root,
                     "traces": [r["decode_traces"] for r in st["replicas"]],
                     "prefills": [r["prefills"] for r in st["replicas"]],
                     "drafted": st["spec_drafted"],
                     "per_device": router.per_device_kv_bytes(),
                     "kv_bytes": router.kv_bytes(),
                     "counts": dict(router.engines[0]._rank.counts)}
    session = Session(cfg, device="cpu", seed=3)
    router = session.serve(dp=2, tp=2, slots=2, max_len=64)
    out["session"] = _run(router, prompts, 6)[1]
    # a dp 2 x tp 2 Plan with fsdp and seq_parallel: from_plan().serve()
    # routes over the plan's own mesh and serves the Megatron layout
    from repro_torch.api import Degrees, Plan
    from repro_torch.configs.base import ShapeConfig
    p = Plan.from_degrees(cfg, ShapeConfig("host", 64, 8, "train"),
                          Degrees(dp=2, tp=2, fsdp=True, seq_parallel=True))
    session = Session.from_plan(cfg, p, device="cpu", dtype="float32")
    session.params = params
    router = session.serve(**ENG)
    homes, streams, res = _run(router, prompts, 6)
    traces = [r["decode_traces"] for r in router.stats["replicas"]]
    out["fsdp_plan"] = {
        "streams": streams, "homes": homes, "traces": traces,
        "done": all(r.done for r in res.values()),
        "same_mesh": router.mesh is session.mesh,
        "fsdp": session.strategy.fsdp and session.strategy.seq_parallel,
        "w_up": tuple(router.engines[0].params["layers"]["mlp"]["w_up"]
                      .shape),
        "counts": dict(router.engines[0]._rank.counts)}
    out["launch"] = {r: v.out for r, v in main(
        ["--device", "cpu", "--dp", "2", "--tp", "2", "--requests", "4",
         "--max-new", "4"]).items()}
    out["cp"] = {shape: cp_rank(shape, cp_flat) for shape in CP_MESHES}
    out["online"] = _online_router_rank(online_flat)
    ssm_cfg = ModelConfig(**SSM_KW)
    router = ReplicaRouter(ssm_cfg, from_numpy(ssm["flat"], ssm_cfg, "cpu"),
                           dp=2, tp=2, **SSM_ENG)
    homes, streams, res = _run(router, ssm["prompts"], 5)
    out["ssm_router"] = {"streams": streams, "homes": homes,
                         "done": all(r.done for r in res.values()),
                         "traces": [r["decode_traces"]
                                    for r in router.stats["replicas"]],
                         "counts": dict(router.engines[0]._rank.counts)}
    out["ssm"] = ssm_model_rank((1, world), ssm["lockstep"])
    moe_cfg = ModelConfig(**MOE_KW)
    _, moe_prompts, _, moe_new, moe_eng = FAMILY_RUNS["moe_mixed"]
    router = ReplicaRouter(moe_cfg, from_numpy(moe_flat, moe_cfg, "cpu"),
                           dp=2, tp=2, strategy=TIE, **moe_eng)
    homes, streams, res = _run(router, moe_prompts, moe_new)
    eng = router.engines[0]
    out["moe_tie_router"] = {
        "streams": streams, "homes": homes,
        "done": all(r.done for r in res.values()),
        "w_up": tuple(eng.params["layers"]["moe"]["w_up"].shape),
        "counts": dict(eng._rank.counts)}
    out["pod"] = _pod_rank(cfg, params, prompts)
    out["vlm"] = _vlm_router_rank(vlm_flat)
    return out


@pytest.fixture(scope="module")
def topology(tmp_path_factory):
    """Every rank's results of the dp 2 x tp 2 runs, from one spawn."""
    prompts = _prompts(2, (5, 7, 6, 8))
    rng = np.random.default_rng(7)
    spec_prompts = [rng.integers(0, 128, size=(n,)).astype(np.int32)
                    for n in (5, 21)]
    for _ in range(2):
        motif = rng.integers(0, 128, size=(int(rng.integers(3, 6)),))
        spec_prompts.append(np.tile(motif, int(rng.integers(4, 7)))
                            .astype(np.int32))
    _jax_params(KW)
    flat = _JAX[KW["name"]][2]
    _jax_params(SSM_KW)
    ssm = {"flat": _JAX[SSM_KW["name"]][2], "prompts": SSM_PROMPTS,
           "lockstep": ssm_flats()}
    ranks = run_ranks(_topology_rank, 4,
                      args=(flat, prompts, spec_prompts,
                            _jax_cp_params()[2], _flat(ONLINE_KW), ssm,
                            _flat(MOE_KW), _flat(VLM_KW)),
                      store_dir=str(tmp_path_factory.mktemp("dp2tp2")),
                      timeout=RANK_TIMEOUT)
    return prompts, spec_prompts, ranks


def test_dp2_tp2_full_topology_matches(topology):
    """tests/test_serve_parallel.py:420 over four gloo ranks: on every
    rank the union of the streams equals the JAX single engine's and the
    routing the JAX router's; one program shape a replica, both prefill;
    half the unsharded pool a rank; two disjoint rows of two ranks, each
    rank's "model" group its row and its root the row's first rank; one
    world all-reduce a round of ``run``."""
    prompts, _, ranks = topology
    want = _jax_streams(KW, prompts, 6, **ENG)
    jr = _jax_router(KW, **ENG)
    jhomes = [jr.submit(i, p, max_new=6) for i, p in enumerate(prompts)]
    from repro.serve.engine import ServeEngine as JaxEngine
    jcfg, jp, _ = _jax_params(KW)
    jdev = JaxEngine(jcfg, jp, **ENG).per_device_kv_bytes()
    rows = ranks[0]["plain"]["rows"]
    assert sorted(sum(map(list, rows), [])) == [0, 1, 2, 3]
    assert not set(rows[0]) & set(rows[1]) and all(len(r) == 2 for r in rows)
    for rank, r in enumerate(ranks):
        run = r["plain"]
        assert run["done"] and run["streams"] == want
        assert run["homes"] == jhomes
        assert run["traces"] == [1, 1] and all(n > 0 for n in run["prefills"])
        assert run["per_device"] * 2 == jdev
        assert run["rows"] == rows and rank in rows[run["row"]]
        assert run["group"] == list(rows[run["row"]])
        assert run["root"] == rows[run["row"]][0]
        assert run["counts"]["router_table"] == len(prompts)
        assert run["counts"]["router_layout"] == 1


def test_dp2_tp2_fsdp_plan_router_serves_the_plain_streams(topology):
    """``Session.from_plan`` of a dp 2 x tp 2 plan with ``fsdp`` and
    ``seq_parallel``: ``serve()`` is the router over the plan's own
    (2, 2) mesh, each engine holding its "model" blocks only (no leaf cut
    over "data": the rows step on their own), and it gives the streams,
    the routing and the collectives of the router without the flags."""
    _, _, ranks = topology
    for r in ranks:
        got, plain = r["fsdp_plan"], r["plain"]
        assert got["fsdp"] and got["same_mesh"] and got["done"]
        assert got["streams"] == plain["streams"]
        assert got["homes"] == plain["homes"]
        assert got["traces"] == plain["traces"]
        assert got["counts"] == plain["counts"]
        assert got["w_up"] == (2, 128, 128)


def test_dp2_tp2_spec_session_and_launcher_match(topology):
    """The same four ranks with spec on (k 4; the tp 2 x dp 2 case of
    tests/test_serve_spec.py:231): the JAX single engine's plain streams,
    drafts made; ``Session.serve(dp=2, tp=2)`` (only the rank's shards
    drawn from the seed) gives ``Session.serve()``'s streams; ``launch/
    serve.py --dp 2 --tp 2`` gives ``--dp 1``'s."""
    from repro_torch.launch.serve import main
    _, spec_prompts, ranks = topology
    want = _jax_streams(KW, spec_prompts, 6, **ENG)
    session = Session(ModelConfig(**KW), device="cpu", seed=3)
    plain = _run(session.serve(slots=2, max_len=64),
                 _prompts(2, (5, 7, 6, 8)), 6)[1]
    launched = {r: v.out for r, v in main(
        ["--device", "cpu", "--requests", "4", "--max-new", "4"]).items()}
    for r in ranks:
        assert r["spec"]["done"] and r["spec"]["streams"] == want
        assert r["spec"]["drafted"] > 0
        assert r["spec"]["traces"] == [1, 1]
        assert r["session"] == plain
        assert r["launch"] == launched


@pytest.mark.parametrize("shape", CP_MESHES)
def test_cp_decode_on_four_ranks_matches_jax(topology, shape):
    """tests/test_cp_attention.py at meshes (1, 4) and (2, 2): on every
    rank the port's lockstep CP decode (at (2, 2) the data row's 2 batch
    rows) equals JAX's CP ``decode_step`` under the same mesh within
    1e-4 and the JAX full forward within 5e-4; each rank's cache holds
    S / tp positions of both K/V heads (Hkv 2 does not divide tp 4: the
    reference's ``cache_pspecs`` shards the sequence there too)."""
    _, _, ranks = topology
    for r in ranks:
        check_cp_rank(r["cp"][shape], shape)
    if shape == (2, 2):
        assert sorted(r["cp"][shape]["row"] for r in ranks) == [0, 0, 1, 1]


#: tests/test_serve_engine.py::test_engine_ssm_matches_sequential's
#: prompts and one more, so both replicas take two
SSM_PROMPTS = _prompts(4, (5, 9, 6, 7))


def test_dp2_tp2_ssm_router_matches_jax_batch(topology):
    """The SSM family over the dp 2 x tp 2 router on four gloo ranks: on
    every rank the union of the streams equals the JAX engine's batch run
    of the same requests, both replicas served, one decode program shape
    each; one ``ssm_out`` and one ``ssm_norm`` sum a Mamba layer a
    program on the replica's row."""
    _, _, ranks = topology
    want = _jax_streams(SSM_KW, SSM_PROMPTS, 5, **SSM_ENG)
    for r in ranks:
        run = r["ssm_router"]
        assert run["done"] and run["streams"] == want
        assert sorted(set(run["homes"])) == [0, 1]
        assert run["traces"] == [1, 1]
        assert run["counts"]["ssm_out"] == run["counts"]["ssm_norm"] > 0
        assert run["counts"]["ssm_out"] % SSM_KW["num_layers"] == 0


def test_ssm_decode_on_four_ranks_matches_jax(topology):
    """tests/test_parallel_equivalence.py::test_decode_sharded_equals_
    reference on (1, 4) for the mamba2 and zamba2 smokes (one SSD head a
    rank), and a prefill and decode steps after it: logits within its
    5e-4, the states and conv tails JAX's for the rank's head."""
    _, _, ranks = topology
    for r in ranks:
        check_ssm_model_rank(r["ssm"])
    assert sorted(r["ssm"]["zamba2-1.2b"]["model_rank"]
                  for r in ranks) == [0, 1, 2, 3]


def test_dp2_tp2_tp_in_expert_moe_router_matches_jax(topology):
    """The MoE with TP inside each expert over the dp 2 x tp 2 router on
    four gloo ranks (one slot a replica, so each request is served alone,
    as by the single engine): on every rank the union of the streams
    equals the JAX engine's ``moe_mixed`` run, both replicas served; each
    rank holds all four experts at half their d_ff, and one ``moe_out``
    sum a layer a program on its row."""
    _, _, ranks = topology
    want = _jax_family_run("moe_mixed")[0]
    layers = MOE_KW["num_layers"]
    for r in ranks:
        run = r["moe_tie_router"]
        assert run["done"] and run["streams"] == want
        assert sorted(set(run["homes"])) == [0, 1]
        assert run["w_up"] == (layers, MOE_KW["num_experts"],
                               MOE_KW["d_model"], MOE_KW["d_ff"] // 2)
        c = run["counts"]
        assert c["moe_out"] == c["attn_out"] == layers * c["tokens"] > 0


#: the collectives every process of a dp x tp router issues (the row
#: ones differ between the rows)
WORLD_LABELS = ("driver_events", "driver_tokens", "router_busy",
                "router_stats", "router_table")


def test_online_dp2_tp2_router_matches_jax_run(topology):
    """tests/test_serve_online.py::test_stream_matches_run_dp2 over four
    gloo ranks: the driver on every rank over the dp 2 x tp 2 router, rank
    0 submitting before the start. Rank 0's streams, row 1's requests'
    included (their tokens returned by row 1's root), equal the JAX
    engine's batch ``run()``; every rank routes each request where the
    lockstep router and the JAX router put it; every rank took part in
    every return; no record is left behind."""
    _, _, ranks = topology
    prompts, new = ONLINE_RUNS["router"]
    jr = _jax_router(ONLINE_KW, **ONLINE_ENG)
    jhomes = [jr.submit(i, p, max_new=new) for i, p in enumerate(prompts)]
    lead = ranks[0]["online"]
    assert lead["lead"] and lead["done"]
    assert lead["streams"] == jax_online("router")
    assert lead["ttft"] == len(prompts)
    assert 0 in jhomes and 1 in jhomes
    for r in ranks:
        run = r["online"]
        assert run["homes"] == run["lockstep"] == jhomes
        assert run["counts"]["driver_tokens"] > 0
        assert {k: run["counts"][k] for k in WORLD_LABELS} == \
            {k: lead["counts"][k] for k in WORLD_LABELS}
        assert run["left"] == (0, 0)
    assert not any(r["online"]["lead"] for r in ranks[1:])


@pytest.mark.parametrize("shape", POD_MESHES)
def test_pod_mesh_engine_and_router_match_jax(topology, shape):
    """Serving on a ("pod", "data", "model") mesh over four gloo ranks:
    each ("pod", "data") coordinate is one tp 2 replica row, pod major.
    On every rank the engine serving its row alone and the dp 2 x tp 2
    router over the mesh give the reference engine's streams on the same
    mesh (which are its single engine's), the router's routing is the JAX
    dp 2 router's, and the row's collectives run on its "model" group,
    rooted at its first rank: the collectives of the ("data", "model")
    router on the same requests."""
    prompts, _, ranks = topology
    want = _jax_pod_streams(shape, prompts, 6)
    assert want == _jax_streams(KW, prompts, 6, **ENG)
    jr = _jax_router(KW, **ENG)
    jhomes = [jr.submit(i, p, max_new=6) for i, p in enumerate(prompts)]
    assert sorted(set(jhomes)) == [0, 1]
    for rank, r in enumerate(ranks):
        run = r["pod"][shape]
        assert run["engine"] == want
        assert run["done"] and run["streams"] == want
        assert run["homes"] == jhomes
        pod, data = run["coord"]
        assert run["row"] == pod * shape[1] + data == rank // 2
        assert run["rows"] == [(0, 1), (2, 3)]
        assert run["group"] == list(run["rows"][run["row"]])
        assert run["root"] == run["engine_root"] == run["rows"][run["row"]][0]
        assert run["traces"] == [1, 1]
        assert run["counts"] == r["plain"]["counts"]
    assert sorted(r["pod"][shape]["coord"] for r in ranks) == sorted(
        (i // shape[1] // 2, i // 2 % shape[1]) for i in range(4))


def test_dp2_tp2_vlm_router_matches_jax_batch(topology):
    """The VLM behind the dp 2 x tp 2 router on four gloo ranks, each
    request with its images, built by hand and through ``Session.serve(
    dp=2, tp=2)``: on every rank the union of the streams equals the JAX
    VLM engine's batch run of the same requests and images, both replicas
    serve, one decode program shape each; a rank holds half the query
    and K/V heads, and one ``attn_out`` and one ``mlp_out`` sum a layer a
    program on its row."""
    _, _, ranks = topology
    want = _jax_family_run("vlm")[0]
    heads = (VLM_KW["num_heads"] // 2, VLM_KW["num_kv_heads"] // 2)
    layers = VLM_KW["num_layers"]
    for r in ranks:
        for name in ("router", "session"):
            run = r["vlm"][name]
            assert run["done"] and run["streams"] == want, name
            assert sorted(set(run["homes"])) == [0, 1]
            assert run["homes"] == r["vlm"]["router"]["homes"]
            assert run["traces"] == [1, 1] and run["heads"] == heads
            c = run["counts"]
            assert c["attn_out"] == c["mlp_out"] == layers * c["tokens"] > 0
