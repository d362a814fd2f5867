"""The port's dry-run (api/session.py::Session.lower / dryrun,
launch/{specs,roofline,dryrun}.py) against the reference's, on the CPU,
and the pieces it stands on: each kernel's ``cost`` and meta branch
(kernels/dispatch.py) and ``launch/roofline.py::Counter``.

* Parity with the reference's ``Session.dryrun`` on the 8 host devices of
  tests/conftest.py, for ``qwen3-smoke`` and ``olmoe-smoke`` on ("data",
  "model") meshes (4, 2) and (2, 2), train / prefill / decode at 8 x 64
  tokens (each JAX record built once and shared): ``model_flops`` equal
  exactly; ``argument_size_in_bytes`` equal exactly (both smokes' heads
  divide tp 2, so the rank layouts agree) but for decode, where the
  port's count holds the cache's 4-byte cursor that ``jax.jit`` drops as
  an unused argument; FLOPs (the port's per rank x chips against
  ``hlo_flops``) equal exactly for the dense smoke, and for the MoE smoke
  in the measured ratio of :data:`MOE_FLOPS_RATIO` (rel 1e-3), whose
  gap is the op classes named there. At (2, 4), where Hkv 2 < tp 4 and
  the layouts differ (the port never splits a head), the port's
  argument bytes are its own blocks'.
* ``effective_config`` and ``choose_strategy`` equal the reference's for
  every arch x shape x (one pod, two) x (base, optimized).
* Meta dry-runs at full width on the 16 x 16 mapping mesh (qwen3-14b
  ``train_4k``: 40 heads over 16, every rank runs all of them; olmoe
  ``prefill_32k``) and one ``--multi-pod`` train record: the trace ends,
  no process group is left, ``ValueError`` with one initialised, DCN
  bytes > 0 across pods, the reference's skip record at ``long_500k``.
* The CLI writes its named record.
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.api import Session  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.strategy import Strategy  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_mlp as fm  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402
from repro_torch.launch import dryrun as td  # noqa: E402
from repro_torch.launch.roofline import Counter  # noqa: E402

#: the reference's record keys (repro/api/session.py::Session.lower)
RECORD_KEYS = {"arch", "shape", "mesh", "status", "strategy",
               "strategy_detail", "compile_s", "memory_analysis",
               "roofline"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes",
               "alias_size_in_bytes"}

ARCHS = ("qwen3-14b", "olmoe-1b-7b")
MESHES = ((4, 2), (2, 2))
KINDS = ("train", "prefill", "decode")
BATCH, SEQ = 8, 64

#: the MoE smoke's FLOPs, port per rank x chips over the reference's
#: ``hlo_flops``, as measured (rel 1e-3): the port computes (i) the
#: router's fp32 (T, d) x (d, E) product whole on every "model" rank,
#: where the reference splits E over "model" (2^20 FLOPs a product: one in
#: prefill; in training four, the forward, its remat recompute and the
#: two backward products); (ii) in decode, a capacity of at least 8 slots
#: an expert for the rank's own 2 rows, where the reference's 8 slots of
#: the 8 rows split over 4 (or 2) data devices. In training each data
#: rank computes its C / batch_dp slice of every expert's capacity, as
#: GSPMD splits the ``moe_cap`` dim (models/moe.py). The dense smoke's
#: FLOPs are equal exactly.
MOE_FLOPS_RATIO = {((4, 2), "train"): 1.0030, ((4, 2), "prefill"): 1.0035,
                   ((4, 2), "decode"): 2.3837, ((2, 2), "train"): 1.0030,
                   ((2, 2), "prefill"): 1.0035, ((2, 2), "decode"): 1.4628}

_JAX = {}


def _jax_record(arch, mesh, kind):
    """The reference's ``Session.dryrun`` record, built once a key."""
    key = (arch, mesh, kind)
    if key not in _JAX:
        import jax
        from repro.api import Session as JaxSession
        from repro.configs import get_smoke as jax_smoke
        from repro.configs.base import ShapeConfig as JaxShape
        from repro.core.strategy import Strategy as JaxStrategy
        from repro.launch.mesh import make_mesh
        devices = jax.devices()[:math.prod(mesh)]
        jcfg = jax_smoke(arch)
        _JAX[key] = JaxSession(
            jcfg, JaxStrategy(dtype=jcfg.dtype),
            make_mesh(mesh, ("data", "model"), devices=devices)).dryrun(
                JaxShape("host", SEQ, BATCH, kind))
    return _JAX[key]


def _port_record(arch, mesh, kind, device="cpu"):
    cfg = get_smoke(arch)
    return Session(cfg, strategy=Strategy(dtype=cfg.dtype), device=device,
                   mesh=dict(zip(("data", "model"), mesh))).dryrun(
        ShapeConfig("host", SEQ, BATCH, kind))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_parity_with_the_reference_dryrun(arch, mesh, kind):
    """model_flops exact; argument bytes exact (+4 in decode: the cache's
    cursor, which jit drops as unused); FLOPs exact for the dense smoke,
    in the measured MoE ratio otherwise; the record's keys."""
    ref = _jax_record(arch, mesh, kind)
    got = _port_record(arch, mesh, kind)
    assert RECORD_KEYS <= set(got) and set(ref) == RECORD_KEYS
    assert set(got["memory_analysis"]) == MEMORY_KEYS
    assert set(got["roofline"]) == set(ref["roofline"])
    assert got["roofline"]["model_flops"] == ref["roofline"]["model_flops"]
    args = got["memory_analysis"]["argument_size_in_bytes"]
    want = ref["memory_analysis"]["argument_size_in_bytes"]
    assert args == want + (4 if kind == "decode" else 0)
    ratio = got["roofline"]["hlo_flops"] / ref["roofline"]["hlo_flops"]
    if arch == "qwen3-14b":
        assert got["roofline"]["hlo_flops"] == ref["roofline"]["hlo_flops"]
    else:
        assert ratio == pytest.approx(MOE_FLOPS_RATIO[(mesh, kind)],
                                      rel=1e-3)
    assert got["roofline"]["chips"] == math.prod(mesh)
    assert got["status"] == "ok" and got["mesh"] == \
        f"{mesh[0]}datax{mesh[1]}model"


def test_hkv_below_tp_holds_to_its_own_blocks():
    """qwen3-smoke at (2, 4): Hkv 2 < tp 4, where the reference's table
    splits ``wk`` / ``wv`` inside a head (its record on this mesh has
    2,767,620 argument bytes) and the port keeps them whole on every rank
    (ROADMAP Queue 3's kept finding): the port's argument bytes are its
    own blocks (``core/tp.py::leaf_blocks``: each param block, AdamW's m,
    v and fp32 master of each update block, the step) and the rank's
    rows."""
    from repro_torch.core import tp
    from repro_torch.params import full_shapes, param_spec
    cfg = get_smoke("qwen3-14b")
    st, axes = Strategy(dtype=cfg.dtype), {"data": 2, "model": 4}
    rec = Session(cfg, strategy=st, device="cpu", mesh=axes).dryrun(
        ShapeConfig("host", SEQ, BATCH, "train"))
    leaves = tp.leaf_blocks(full_shapes(cfg), st, axes, cfg)
    esize = {k: torch.empty((), dtype=d).element_size()
             for k, (_, d, _) in param_spec(cfg).items()}
    params = sum(math.prod(tp.local_shape(lb.shape, lb.spec, axes))
                 * esize[k] for k, lb in leaves.items())
    state = sum(3 * 4 * math.prod(tp.local_shape(lb.shape, lb.update, axes))
                for lb in leaves.values()) + 4
    rows = BATCH // axes["data"] * SEQ * 4
    args = rec["memory_analysis"]["argument_size_in_bytes"]
    assert args == params + state + rows
    assert args != 2767620


# ------------------------------------------------ effective config, strategy

@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's launch/dryrun.py, imported with its XLA_FLAGS
    setting undone: JAX's backend is initialised first (so the flag it
    sets at import changes nothing), and the variable restored after."""
    import jax
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


class _RefMesh:
    """What the reference's ``choose_strategy`` reads of a mesh."""

    def __init__(self, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_effective_config_and_strategy_match_the_reference(ref_dryrun,
                                                           multi_pod):
    from repro.configs import SHAPES as JAX_SHAPES
    from repro_torch.configs import ARCH_NAMES, SHAPES
    axes = td.production_mesh(multi_pod=multi_pod)
    assert axes == ({"pod": 2, "data": 16, "model": 16} if multi_pod
                    else {"data": 16, "model": 16})
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            cfg, pol = td.effective_config(arch, shape)
            jcfg, jpol = ref_dryrun.effective_config(arch, shape)
            assert pol == jpol
            if cfg is None:
                assert jcfg is None
                continue
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            for optimized in (False, True):
                st = td.choose_strategy(cfg, SHAPES[shape], axes,
                                        optimized=optimized)
                jst = ref_dryrun.choose_strategy(
                    jcfg, JAX_SHAPES[shape], _RefMesh(axes),
                    optimized=optimized)
                assert dataclasses.asdict(st) == dataclasses.asdict(jst), \
                    (arch, shape, optimized)


# --------------------------------------------------------- full-size traces

def _keys_and_cleanup(rec):
    assert RECORD_KEYS <= set(rec) and rec["status"] == "ok"
    assert set(rec["memory_analysis"]) == MEMORY_KEYS
    assert not dist.is_initialized()


def test_qwen3_train_4k_on_16x16():
    """qwen3-14b train_4k as rank 0 of the 16 x 16 mapping mesh, as the
    card's branch: every rank runs all 40 heads (40 % 16), flash charged
    once a layer forward and once in each remat recompute; the tp sums
    cross NVLink nodes of 8 ("dcn"); nothing left behind."""
    cfg = get_config("qwen3-14b")
    rec = Session(cfg, mesh={"data": 16, "model": 16}).dryrun("train_4k")
    _keys_and_cleanup(rec)
    assert rec["kernels"]["flash_attention"]["launches"] == \
        2 * cfg.num_layers
    assert {c["kind"] for c in rec["collectives"].values()} == {"dcn"}
    assert rec["roofline"]["chips"] == 256
    assert rec["memory_analysis"]["alias_size_in_bytes"] > 0


def test_olmoe_prefill_32k_and_multi_pod_train():
    """olmoe prefill_32k on 16 x 16 (``lower_one``), and whisper-tiny's
    train_4k on 2 x 16 x 16 (the baseline strategy at one microbatch: the
    trace's seconds grow with them): DCN bytes > 0 (the pods' gradient
    sums)."""
    rec, lowered = td.lower_one("olmoe-1b-7b", "prefill_32k",
                                verbose=False)
    _keys_and_cleanup(rec)
    assert lowered.counter.flops > 0 and rec["kernels"]["flash_attention"]
    cfg, mesh = get_config("whisper-tiny"), td.production_mesh(multi_pod=True)
    st = td.choose_strategy(cfg, td.SHAPES["train_4k"], mesh)
    pod, _ = td.lower_one("whisper-tiny", "train_4k", multi_pod=True,
                          strategy=st.with_(microbatches=1), verbose=False)
    _keys_and_cleanup(pod)
    assert pod["mesh"] == "pod2x16x16" and pod["roofline"]["chips"] == 512
    assert pod["roofline"]["coll_dcn_bytes_per_dev"] > 0
    assert pod["collectives"]["dp_grads"]["axis"] == "batch"


def test_long_500k_full_attention_is_the_reference_skip(ref_dryrun):
    for arch in ("olmoe-1b-7b", "whisper-tiny", "kimi-k2-1t-a32b"):
        for multi_pod in (False, True):
            rec, lowered = td.lower_one(arch, "long_500k",
                                        multi_pod=multi_pod, verbose=False)
            assert lowered is None and rec["status"].startswith("skipped")
            assert (rec, lowered) == ref_dryrun.lower_one(
                arch, "long_500k", multi_pod=multi_pod, verbose=False)


def test_refuses_beside_a_process_group(tmp_path):
    """A fake group of the mesh's ranks cannot sit beside a caller's:
    ValueError, and the caller's group is left as it was."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="already initialised"):
            Session(get_smoke("qwen3-14b"), device="cpu",
                    mesh={"data": 2, "model": 2}).dryrun(
                ShapeConfig("host", SEQ, BATCH, "train"))
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh", [None, {"data": 2, "model": 2},
                                  {"pod": 2, "data": 1, "model": 2}])
def test_every_kind_allocates_only_on_meta(mesh):
    """train / prefill / decode on one chip, a (dp, tp) and a ("pod",
    "data", "model") mapping: the reference's keys, every argument a meta
    tensor and every tensor an op makes while the step runs on the meta
    device (but ``lift_fresh``, the host constant a numpy array becomes
    before it moves to the device: RoPE's frequencies; the process
    group's rank tables before the step are host tensors of rank ids),
    no group left; an error inside the trace destroys the group too."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class MetaOnly(TorchDispatchMode):
        off = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if dispatch._sinks:       # the step runs (under its Counter)
                self.off += [str(func) for t in tree_flatten(out)[0]
                             if isinstance(t, torch.Tensor) and not t.is_meta
                             and func is not torch.ops.aten.lift_fresh.default]
            return out

    cfg = get_smoke("qwen3-14b")
    for kind in KINDS:
        watch = MetaOnly()
        with watch:
            rec, lowered = Session(cfg, device="cuda", mesh=mesh).lower(
                ShapeConfig("host", SEQ, BATCH, kind))
        _keys_and_cleanup(rec)
        assert not watch.off, watch.off[:5]
        args = [t for t in tree_flatten(lowered.args)[0]
                if isinstance(t, torch.Tensor)]
        assert args and all(t.is_meta for t in args)
    broken = Session(cfg.with_(num_heads=6, num_kv_heads=3), device="cpu",
                     mesh={"data": 2, "model": 2})
    with pytest.raises(ValueError, match="KV heads"):   # Hkv 3 over tp 2
        broken.dryrun(ShapeConfig("host", SEQ, BATCH, "train"))
    assert not dist.is_initialized()


def test_cli_writes_the_named_record(tmp_path):
    td.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--out",
             str(tmp_path)])
    rec = json.loads((tmp_path / "whisper-tiny__decode_32k__pod16x16__"
                      "base.json").read_text())
    assert rec["status"] == "ok" and rec["arch"] == "whisper-tiny"
    assert set(rec["memory_analysis"]) == MEMORY_KEYS
    assert not dist.is_initialized()


# --------------------------------------------------- kernels' cost and meta

def _pairs_by_mask(s, t, causal, window):
    from repro_torch.kernels.ref import causal_window_mask
    return int(causal_window_mask(s, t, causal=causal,
                                  window=window).sum())


@pytest.mark.parametrize("s,t,causal,window", [
    (64, 64, True, 0), (37, 64, True, 0), (64, 37, True, 0),
    (50, 50, False, 0), (80, 80, True, 16), (20, 90, False, 7)])
def test_flash_cost_counts_the_live_pairs(s, t, causal, window):
    assert fa.live_pairs(s, t, causal=causal, window=window) == \
        _pairs_by_mask(s, t, causal, window)
    flops, nbytes = fa.cost(2, s, t, 8, 2, 16, causal=causal, window=window)
    assert flops == 4.0 * 8 * 16 * 2 * _pairs_by_mask(s, t, causal, window)
    assert nbytes == 2 * (2 * 2 * s * 8 * 16 + 2 * 2 * t * 2 * 16)


def test_kernel_costs_are_phase_3s_formulas():
    """The bound column's work at the main shapes (chip_smoke.py phase 3):
    flash at the training shape, the MLP at T 256, the SSD scan at the
    SSM prefill, paged attention over pages shared by rows."""
    b, s, hq, hkv, d = 1, 4096, 40, 8, 128
    assert fa.cost(b, s, s, hq, hkv, d) == (
        4.0 * hq * d * (b * s * (s + 1) // 2),
        2 * (2 * b * s * hq * d + 2 * b * s * hkv * d))
    assert fm.cost(256, 5120, 17408) == (6.0 * 256 * 5120 * 17408,
                                         2 * (3 * 5120 * 17408
                                              + 2 * 256 * 5120))
    b, s, h, p, n, q = 1, 1024, 48, 64, 128, 128
    nc, pairs = s // q, q * (q + 1) // 2
    assert sk.cost(b, s, h, p, n, chunk=q) == (
        2.0 * b * nc * (pairs * n + h * (pairs * p + 2 * q * n * p)),
        2 * (2 * b * s * h * p + 2 * b * s * n)
        + 4 * (b * s * h + h + b * h * p * n))
    tab = np.array([[3, 4, 5, 0], [3, 4, 6, 0], [7, 0, 0, 0]], np.int32)
    pos = np.array([40, 44, 3], np.int32)
    # rows 0 and 1 share pages 3 and 4 (32 keys); 9 + 13 + 4 keys more
    assert pa.live_tokens(tab, pos, 16) == 32 + 9 + 13 + 4
    flops, nbytes = pa.cost(tab, pos, 8, 2, 64, 16)
    assert flops == 4.0 * 8 * 64 * (41 + 45 + 4)
    assert nbytes == 58 * 2 * 64 * 2 * 2 + 2 * 3 * 8 * 64 * 2 + 4 * (12 + 3)


def test_scratch_mirrors():
    """The Python sizes of the C entries' scratch (the card's tests hold
    them to the built libraries)."""
    assert sk.scratch_words(1, 1024, 48, 64, 128, 128) == \
        8 * 128 * 128 + 1024 * 48 + 8 * 48 * 64 * 128
    assert sk.scratch_words(1, 1, 1, 1, 1, 1) >= 1
    plan, part = pa.scratch_bytes(4, 40, 128, 64, 16)
    assert plan % 256 == 0 and plan >= 4 * (((4 + 8 + 3) & ~3) + 4 * 4 * 4)
    assert part == 4 * 4 * 40 * 130 * 4


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_meta_takes_the_named_branch():
    """On meta the wrappers take the branch ``as_device`` names: "cuda"
    the kernel's checks (a shape it refuses raises as on the card) and
    outputs, each launch charged once and nothing launched; "cpu" the
    plain version, nothing charged. Outside ``as_device`` a meta tensor
    raises."""
    q, k = _meta(1, 64, 8, 64), _meta(1, 64, 2, 64)
    x, wg, wd = _meta(32, 64), _meta(64, 128), _meta(128, 64)
    launches = (fa.flash_attention.launches, fm.fused_mlp.launches)
    with pytest.raises(ValueError, match="as_device"):
        fa.flash_attention(q, k, k)
    with Counter() as c, dispatch.as_device("cuda"):
        out = fa.flash_attention(q, k, k)
        y = fm.fused_mlp(x, wg, wg, wd)
        ys, hs = sk.ssd_scan(_meta(1, 64, 4, 16),
                             _meta(1, 64, 4, dtype=torch.float32),
                             _meta(4, dtype=torch.float32), _meta(1, 64, 8),
                             _meta(1, 64, 8), chunk=32)
        with pytest.raises(ValueError, match="head dims"):
            fa.flash_attention(_meta(1, 8, 2, 12), _meta(1, 8, 2, 12),
                               _meta(1, 8, 2, 12))
    assert (out.shape, out.dtype, out.is_meta) == (q.shape, q.dtype, True)
    assert y.shape == (32, 64) and ys.shape == (1, 64, 4, 16)
    assert hs.shape == (1, 4, 16, 8) and hs.dtype == torch.float32
    assert {n: v["launches"] for n, v in c.kernels.items()} == \
        {"flash_attention": 1, "fused_mlp": 1, "ssd_scan": 1}
    assert c.kernels["fused_mlp"]["flops"] == 6.0 * 32 * 64 * 128
    assert c.kernels["ssd_scan"]["scratch_bytes"] == \
        4 * sk.scratch_words(1, 64, 4, 16, 8, 32)
    assert (fa.flash_attention.launches, fm.fused_mlp.launches) == launches
    with Counter() as c, dispatch.as_device("cpu"):
        out = fa.flash_attention(q, k, k)
    assert out.is_meta and c.kernels == {} and c.flops > 0


def test_counter_counts_matmuls_bytes_and_memory():
    """mm / bmm FLOPs, each op's inputs and new outputs (an in-place
    result once, a view not at all), and live bytes by storage."""
    a, b = torch.ones(4, 8), torch.ones(8, 16)
    with Counter() as c:
        y = a @ b                       # mm: 2 * 4 * 8 * 16
        y.add_(1.0)                     # in place: y read once
        y.view(16, 4)                   # a view: nothing
        z = torch.bmm(torch.ones(2, 3, 5), torch.ones(2, 5, 7))
        del z
    assert c.flops == 2 * 4 * 8 * 16 + 2 * 2 * 3 * 5 * 7
    mm_bytes = 4 * (32 + 128 + 64)
    assert c.bytes >= mm_bytes + 4 * 64
    assert c.peak >= 4 * 64 and c.live <= c.peak
