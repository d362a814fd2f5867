"""The planner in the port (core/{opgraph,costmodel,planner}.py) against
the reference's, on the CPU with no process group: the twins of
tests/test_opgraph.py and tests/test_planner_costmodel.py.

* ``build_opgraph`` on every config of ``ARCH_NAMES``: every node field,
  the edges, the totals, ``layer_nodes`` and ``balanced_stages``, equal
  to the reference's exactly (the same expressions in the same order);
* for each hardware entry — the port's ``H100`` and the reference's
  five (``V5E``, ``A100``, ``V100``, ``TPU_V3``, ``TPU_V4``; the port
  holds no TPU constants, so those are built here from the reference's
  fields, and the reference gets ``H100``'s the same way) — on every
  config of ``ARCH_NAMES``, the four ``SHAPES`` and chips 1, 8 and 64
  (256 for the "dp" search only): ``legal_degrees``, ``estimate``'s
  ``CostBreakdown`` on every legal point and the Plan of each of the
  three searches (degrees, cost, MFU, fits, evaluations, stage cuts and
  breakdown; "mcmc", 201 evaluations a plan, on one config of each
  family, ``MCMC_ARCHS``) equal field for field with exact float
  equality, or both raise the same exception (an empty search space).
  ``build_opgraph`` is pure, so both packages' estimates read a memo of
  their own package's graph here: the sweep costs seconds, not minutes;
* the invariants of the two reference test files, on the port with
  ``H100``: the param count against the port's ``init_params`` on the
  smoke configs, the chained graph, balanced stages, linear FLOPs,
  legal degrees that tile, finite positive terms, more chips never
  slower, Korthikanti's formulas, feasible searches, the search quality
  ordering and MoE plans with ep = tp;
* ``launch/train.py --plan``'s line, and ``Plan.materialize`` without a
  process group: one chip gives no mesh, the tiling and availability
  checks, and a plan of dp 2 at tp 1 on a device list, which serves two
  replicas in this process (``Session.from_plan(...).serve()``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_NAMES as REF_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.core import costmodel as rcost  # noqa: E402
from repro.core import opgraph as rgraph  # noqa: E402
from repro.core import planner as rplan  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, SHAPES, get_config,  # noqa: E402
                                 get_smoke)
from repro_torch.configs.base import ModelConfig, ShapeConfig  # noqa: E402
from repro_torch.core import costmodel as cost  # noqa: E402
from repro_torch.core import opgraph as graph  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.costmodel import (H100, Degrees,  # noqa: E402
                                        activation_bytes_per_layer,
                                        estimate)
from repro_torch.core.planner import (SEARCH_METHODS, Plan,  # noqa: E402
                                      legal_degrees, plan)

#: hardware name -> (the port's entry, the reference's entry)
HARDWARE = {"H100": (H100, rcost.Hardware(**dataclasses.asdict(H100)))}
HARDWARE.update({
    name: (cost.Hardware(**dataclasses.asdict(getattr(rcost, name))),
           getattr(rcost, name))
    for name in ("V5E", "A100", "V100", "TPU_V3", "TPU_V4")})

CHIPS = (1, 8, 64)
#: one config of each family: the "mcmc" search's configs
MCMC_ARCHS = ("qwen3-14b", "olmoe-1b-7b", "mamba2-780m", "zamba2-1.2b",
              "whisper-tiny", "llama-3.2-vision-90b")


def test_arch_and_shape_registries_match():
    assert tuple(ARCH_NAMES) == tuple(REF_ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    # the port's hardware table: H100 and the reference's GPU entries,
    # no TPU entry; H100 the default everywhere the reference has V5E's
    assert cost.A100 == HARDWARE["A100"][0]
    assert cost.V100 == HARDWARE["V100"][0]
    assert cost.Hardware() == H100
    for name in ("V5E", "TPU_V3", "TPU_V4"):
        assert not hasattr(cost, name)
    import inspect
    for fn in (estimate, Plan.from_degrees, planner.search_exhaustive,
               planner.search_dp, planner.search_mcmc, plan):
        defaults = [p.default for p in
                    inspect.signature(fn).parameters.values()]
        assert H100 in defaults, fn


def _node_rows(g):
    return [dataclasses.asdict(n) for n in g.nodes]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_opgraph_matches_reference(arch):
    """Every node, edge and total of ``build_opgraph``, its layer nodes
    and ``balanced_stages`` at 1-8 stages, at (4, 512) and each shape's
    (global_batch, seq_len)."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    for b, s in [(4, 512)] + [(sh.global_batch, sh.seq_len)
                              for sh in SHAPES.values()]:
        g, r = graph.build_opgraph(cfg, b, s), rgraph.build_opgraph(rcfg, b, s)
        assert _node_rows(g) == _node_rows(r)
        assert g.edges == r.edges
        assert g.total_flops() == r.total_flops()
        assert g.total_param_bytes() == r.total_param_bytes()
        assert {k: [n.name for n in v] for k, v in g.layer_nodes().items()} \
            == {k: [n.name for n in v] for k, v in r.layer_nodes().items()}
        for p in (1, 2, 3, 4, 8):
            assert g.balanced_stages(p) == r.balanced_stages(p), (b, s, p)


@pytest.fixture(scope="module")
def memo_graphs():
    """Both packages' cost model and planner read a memo of their own
    ``build_opgraph`` (a pure function of its arguments)."""
    with pytest.MonkeyPatch.context() as mp:
        for mods in ((cost, planner, graph), (rcost, rplan, rgraph)):
            memo = functools.lru_cache(maxsize=None)(mods[2].build_opgraph)
            for m in mods[:2]:
                mp.setattr(m, "build_opgraph", memo)
        yield


def _plan_row(p):
    return (p.row(), p.stage_layers, vars(p.breakdown))


def _same_plan(search, ref_search, space, args, ref_args):
    """The port's Plan equals the reference's field for field; on an
    empty search space both raise the same exception."""
    if not space:
        for fn, a in ((search, args), (ref_search, ref_args)):
            with pytest.raises((TypeError, IndexError)):
                fn(*a)
        return
    got, want = search(*args), ref_search(*ref_args)
    assert _plan_row(got) == _plan_row(want), args[1:3]


@pytest.mark.parametrize("hw_name", sorted(HARDWARE))
def test_estimate_and_searches_match_reference(memo_graphs, hw_name):
    hw, rhw = HARDWARE[hw_name]
    points = searched = 0
    for arch in ARCH_NAMES:
        cfg, rcfg = get_config(arch), ref_config(arch)
        for name, shape in SHAPES.items():
            rshape = REF_SHAPES[name]
            for chips in CHIPS:
                degs = legal_degrees(cfg, shape, chips)
                rdegs = rplan.legal_degrees(rcfg, rshape, chips)
                assert [dataclasses.asdict(d) for d in degs] == \
                    [dataclasses.asdict(d) for d in rdegs], (arch, name)
                for d, rd in zip(degs, rdegs):
                    got = estimate(cfg, shape, d, hw)
                    want = rcost.estimate(rcfg, rshape, rd, rhw)
                    assert vars(got) == vars(want), (arch, name, d)
                    points += 1
                for method in SEARCH_METHODS:
                    if method == "mcmc" and arch not in MCMC_ARCHS:
                        continue
                    _same_plan(SEARCH_METHODS[method],
                               rplan.SEARCH_METHODS[method], degs,
                               (cfg, shape, chips, hw),
                               (rcfg, rshape, chips, rhw))
                    searched += 1
            _same_plan(planner.search_dp, rplan.search_dp,
                       legal_degrees(cfg, shape, 256), (cfg, shape, 256, hw),
                       (rcfg, rshape, 256, rhw))
    assert points > 4000
    assert searched == (2 * len(ARCH_NAMES) + len(MCMC_ARCHS)) * 4 * 3


def test_estimate_extra_terms_match_reference():
    """``dcn_dp`` and every knob of ``Degrees`` off its searched value
    (fsdp, zero1 off, remat off, ep) on one dense and one MoE config."""
    for arch in ("qwen3-14b", "olmoe-1b-7b"):
        cfg, rcfg = get_config(arch), ref_config(arch)
        for kw in (dict(dp=8, tp=4, pp=2, microbatches=4, fsdp=True),
                   dict(dp=4, tp=8, zero1=False, remat=False),
                   dict(dp=2, tp=4, ep=4, seq_parallel=True),
                   dict(dp=16, tp=16)):
            for name in ("train_4k", "prefill_32k"):
                for dcn in (1, 2):
                    got = estimate(cfg, SHAPES[name], Degrees(**kw), H100,
                                   dcn_dp=dcn)
                    want = rcost.estimate(rcfg, REF_SHAPES[name],
                                          rcost.Degrees(**kw),
                                          HARDWARE["H100"][1], dcn_dp=dcn)
                    assert got.row() == want.row(), (arch, kw, name, dcn)


# ------------------------------------------------------- the invariants

@pytest.mark.parametrize("arch", ["qwen3-14b", "minitron-4b", "olmoe-1b-7b",
                                  "mamba2-780m"])
def test_param_count_matches_initializer(arch):
    """tests/test_opgraph.py: ``param_count`` within 5% of the port's
    ``init_params`` tree on the smoke config."""
    from repro_torch.params import init_params
    from repro_torch.tree import flatten
    cfg = get_smoke(arch).with_(dtype="float32")
    real = sum(v.numel() for v in flatten(
        init_params(cfg, device="cpu", seed=0)).values())
    pred = cfg.param_count()
    assert abs(real - pred) / real < 0.05, (real, pred)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_opgraph_builds_and_is_chained(arch):
    g = graph.build_opgraph(get_config(arch), batch=4, seq=512)
    assert g.total_flops() > 0 and g.total_param_bytes() > 0
    names = {n.name for n in g.nodes}
    for a, b in g.edges:
        assert a in names and b in names
    assert len(g.edges) == len(g.nodes) - 1      # linear chain


def test_balanced_stages_cover_all_layers():
    g = graph.build_opgraph(get_config("deepseek-coder-33b"), 4, 512)
    per = {k: sum(n.flops for n in v) for k, v in g.layer_nodes().items()}
    for p in (2, 4, 8):
        stages = g.balanced_stages(p)
        assert len(stages) == p
        flat = [li for st in stages for li in st]
        assert sorted(flat) == sorted(set(flat))
        loads = [sum(per[li] for li in st) for st in stages if st]
        assert max(loads) / max(min(loads), 1) < 1.6


def test_flops_scale_linearly_with_tokens():
    cfg = get_config("internlm2-20b")
    f1 = graph.build_opgraph(cfg, 2, 256).total_flops()
    f2 = graph.build_opgraph(cfg, 4, 256).total_flops()
    assert f2 == pytest.approx(2 * f1, rel=1e-6)


def test_legal_degrees_partition_chips():
    cfg, shape = get_config("qwen3-14b"), SHAPES["train_4k"]
    for deg in legal_degrees(cfg, shape, 64):
        assert deg.dp * deg.tp * deg.pp == 64
        assert shape.global_batch % deg.dp == 0
        assert (shape.global_batch // deg.dp) % deg.microbatches == 0
        assert deg.pp <= cfg.num_layers


@pytest.mark.parametrize("chips", [8, 16, 64, 256])
@pytest.mark.parametrize("arch", ["qwen3-14b", "olmoe-1b-7b", "mamba2-780m"])
def test_estimate_terms_positive_and_finite(chips, arch):
    """tests/test_planner_costmodel.py's property test, on every point of
    its sampled grid, with H100."""
    cfg, shape = get_config(arch), SHAPES["train_4k"]
    for deg in legal_degrees(cfg, shape, chips)[:8]:
        cb = estimate(cfg, shape, deg, H100)
        assert cb.t_compute > 0 and cb.step_time > 0
        assert cb.t_memory >= 0 and cb.t_collective >= 0
        assert 0 <= cb.bubble_fraction < 1
        assert 0 <= cb.mfu <= 2.5   # SSD archs exceed the 6ND proxy


def test_more_chips_never_slower():
    cfg, shape = get_config("qwen3-14b"), SHAPES["train_4k"]
    assert plan(cfg, shape, 256).cost <= plan(cfg, shape, 64).cost * 1.05


def test_korthikanti_formulas():
    """Paper §5.1: the SP formula at t=1 equals the no-SP formula at t=1,
    and SP strictly dominates for t>1; SP removes the 10·s·b·h floor."""
    cfg = get_config("qwen3-14b")
    s, b = 4096, 1
    assert activation_bytes_per_layer(cfg, b, s, 1, False) == \
        pytest.approx(activation_bytes_per_layer(cfg, b, s, 1, True))
    for t in (2, 4, 8, 16):
        assert (activation_bytes_per_layer(cfg, b, s, t, True)
                < activation_bytes_per_layer(cfg, b, s, t, False))
    t = 8
    no_sp = activation_bytes_per_layer(cfg, b, s, t, False)
    sp = activation_bytes_per_layer(cfg, b, s, t, True)
    assert no_sp - sp == pytest.approx(10 * s * b * cfg.d_model * (1 - 1 / t),
                                       rel=1e-6)


@pytest.mark.parametrize("method", list(SEARCH_METHODS))
def test_search_methods_return_feasible(method):
    p = plan(get_config("minitron-4b"), SHAPES["train_4k"], 256,
             method=method)
    assert p.fits and p.cost > 0
    assert p.degrees.dp * p.degrees.tp * p.degrees.pp == 256


def test_search_quality_ordering():
    """Exhaustive is the floor; dp/mcmc must come within 25%."""
    cfg, shape = get_config("internlm2-20b"), SHAPES["train_4k"]
    best = plan(cfg, shape, 256, method="exhaustive").cost
    for m in ("dp", "mcmc"):
        assert plan(cfg, shape, 256, method=m).cost <= best * 1.25


def test_moe_planner_uses_ep():
    p = plan(get_config("olmoe-1b-7b"), SHAPES["train_4k"], 256)
    assert p.degrees.ep == p.degrees.tp


def test_mfu_passes_one_where_the_model_flops_count_the_embedding():
    """A kept finding of the reference's cost model, copied as it is: the
    model FLOPs take ``active_param_count()``, embedding table included,
    which the operator graph gives no FLOPs, so a short model's MFU
    passes 100% on H100 (Qwen3-14B at 2 layers, 4 x 1024 prefill), and
    "decode" counts tokens as "prefill" does."""
    cfg = get_config("qwen3-14b")
    pre = ShapeConfig("p", 1024, 4, "prefill")
    one = Degrees(remat=False, zero1=False)
    assert estimate(cfg, pre, one).mfu > 1.0
    assert estimate(cfg.with_(num_layers=2), pre, one).mfu > 1.4
    dec = ShapeConfig("d", 1024, 4, "decode")
    assert estimate(cfg, dec, one).row() == estimate(cfg, pre, one).row()


# ------------------------------------------ the launcher, materialize

def test_train_launcher_plan_line(capsys):
    """``launch/train.py --plan`` prints the "dp" search's summary for
    the arch's full config at train_4k on 256 H100s — the reference's
    line with the reference's planner on H100's fields."""
    from repro_torch.launch import train as launcher
    for arch in ("minitron-4b", "qwen3-14b", "olmoe-1b-7b"):
        line = launcher.main(["--arch", arch, "--plan"])
        assert capsys.readouterr().out.strip() == line
        want = rplan.plan(ref_config(arch), REF_SHAPES["train_4k"], 256,
                          method="dp", hw=HARDWARE["H100"][1])
        assert line == f"{arch}: {want.summary()}"
    assert line.startswith("olmoe-1b-7b: plan[dp] dp")


CFG = ModelConfig(name="api-test", arch_type="dense", num_layers=2,
                  d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                  vocab_size=128, dtype="float32")
SHAPE = ShapeConfig("host", 64, 8, "train")


def _manual(**kw):
    return Plan(degrees=Degrees(**kw), cost=0.0, mfu=0.0, fits=True,
                evaluations=1, method="manual")


def test_materialize_without_a_process_group():
    """One chip needs no process group (mesh None); degrees that do not
    tile the one device, or more devices than there are, raise the
    reference's messages; the strategy carries the plan's fields and the
    overrides."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    p = plan(CFG, SHAPE, chips=1)
    strategy, mesh = p.materialize(remat=False, dtype="float32")
    assert mesh is None and strategy.name == "plan/exhaustive"
    assert not strategy.remat and strategy.dtype == "float32"
    assert strategy.microbatches == p.degrees.microbatches
    with pytest.raises(ValueError, match="do not tile"):
        _manual(dp=3).materialize()
    with pytest.raises(ValueError, match="available"):
        _manual(dp=2).materialize(devices=2)
    with pytest.raises(ValueError, match="must share the model axis"):
        _manual(tp=2, ep=3).materialize(devices=["cpu"] * 2)


def test_dp_plan_on_a_device_list_serves_replicas_in_one_process():
    """A plan of dp 2 at tp 1 materialised on a device list (one device
    repeated): one ``ReplicaSlice`` a replica; ``Session.from_plan(...)
    .serve()`` is a 2-replica router whose streams equal one engine's on
    the same params; tp or pp on a device list, and training such a
    session, raise."""
    from repro_torch.api import Session
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.parallel import ReplicaRouter, ReplicaSlice
    p = Plan.from_degrees(CFG, SHAPE, Degrees(dp=2))
    strategy, mesh = p.materialize(devices=["cpu", "cpu"])
    assert [type(m) for m in mesh] == [ReplicaSlice, ReplicaSlice]
    assert all(m.devices == (torch.device("cpu"),) for m in mesh)
    session = Session.from_plan(CFG, p, devices=["cpu"] * 2, device="cpu",
                                seed=3, dtype="float32")
    assert session.plan is p and session.strategy.name == "plan/manual"
    router = session.serve(slots=2, max_len=64)
    plain = session.serve(dp=1, slots=2, max_len=64)
    assert isinstance(router, ReplicaRouter) and router.dp == 2
    assert isinstance(plain, ServeEngine)
    prompts = [np.random.default_rng(3).integers(0, 128, size=(n,))
               .astype(np.int32) for n in (5, 7, 6)]
    for i, pr in enumerate(prompts):
        router.submit(i, pr, max_new=5)
        plain.submit(i, pr, max_new=5)
    a, b = router.run(), plain.run()
    assert {i: a[i].out for i in a} == {i: b[i].out for i in b}
    with pytest.raises(ValueError, match="needs a process group of 2"):
        session.train(global_batch=2, seq_len=16)
    for kw in (dict(tp=2), dict(dp=1, pp=2)):
        with pytest.raises(ValueError, match="device list"):
            _manual(**kw).materialize(devices=["cpu"] * 2)
