"""The port's sharding tables (core/sharding.py, core/strategy.py,
core/pspec.py) against the reference's, leaf for leaf, with no process
group: the twins of tests/test_sharding_rules.py.

The trees are the reference's own, built with ``jax.eval_shape`` (nothing
is allocated or compiled): every shipped config's smoke and the tiny test
configs, their optimizer states (AdamW, Adafactor) and their caches
(dense rows at a batch that divides the data axis and one that does not,
and the serving engine's paged pool). The reference reads a JAX mesh
over conftest's 8 host devices; the port reads ``{axis: size}``. Each
spec must equal the reference's ``PartitionSpec`` entry for entry, on
("data", "model") = (1, 2), (2, 2), (1, 4) and (2, 4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs import ARCH_NAMES, get_smoke  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.core import sharding as jshd  # noqa: E402
from repro.core.strategy import Strategy as JaxStrategy  # noqa: E402
from repro.launch.mesh import make_mesh as jax_mesh  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.train.step import init_opt_state  # noqa: E402
from repro_torch.core import sharding as shd  # noqa: E402
from repro_torch.core.pspec import P  # noqa: E402
from repro_torch.core.strategy import Strategy  # noqa: E402

SHAPES = ((1, 2), (2, 2), (1, 4), (2, 4))

#: tests/test_serve_parallel.py's tiny configs and one with a single KV
#: head (replicated wherever the model axis is > 1)
TINY = {
    "par-dense": dict(name="par-dense", arch_type="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=128, dtype="float32"),
    "par-dense-kv1": dict(name="par-dense-kv1", arch_type="dense",
                          num_layers=2, d_model=128, num_heads=4,
                          num_kv_heads=1, d_ff=256, vocab_size=128,
                          dtype="float32"),
    "par-moe": dict(name="par-moe", arch_type="moe", num_layers=2,
                    d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                    num_experts=4, experts_per_token=2, vocab_size=128,
                    dtype="float32"),
}
CONFIGS = tuple(ARCH_NAMES) + tuple(TINY)

_TREES = {}


def _cfg(name):
    return JaxConfig(**TINY[name]) if name in TINY else get_smoke(name)


def _params(name):
    if name not in _TREES:
        cfg = _cfg(name)
        _TREES[name] = jax.eval_shape(
            lambda: get_model(cfg).init(jax.random.key(0), cfg))
    return _TREES[name]


def _meshes():
    for shape in SHAPES:
        yield (jax_mesh(shape, ("data", "model")),
               {"data": shape[0], "model": shape[1]})


def _same(ref, mine, where=""):
    """Every leaf spec of ``ref`` (PartitionSpecs) equals ``mine``'s."""
    if isinstance(ref, PartitionSpec):
        assert isinstance(mine, P), where
        assert tuple(mine) == tuple(ref), (where, tuple(mine), tuple(ref))
        return 1
    assert isinstance(ref, dict) and ref.keys() == mine.keys(), where
    return sum(_same(ref[k], mine[k], f"{where}/{k}") for k in ref)


@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_match_reference(name):
    """``param_pspecs`` with FSDP off and on, and the rules table."""
    params = _params(name)
    n = 0
    for jmesh, axes in _meshes():
        for fsdp in (False, True):
            ref = jshd.param_pspecs(params, JaxStrategy(fsdp=fsdp), jmesh)
            mine = shd.param_pspecs(params, Strategy(fsdp=fsdp), axes)
            n += _same(ref, mine)
        assert Strategy().rules(axes) == JaxStrategy().rules(jmesh)
    assert n > 0


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("name", CONFIGS)
def test_opt_state_specs_match_reference(name, optimizer):
    """``opt_state_pspecs`` (ZeRO-1 on and off; full-shape, row- and
    column-factored leaves) over the reference's optimizer state."""
    params = _params(name)
    opt = jax.eval_shape(lambda p: init_opt_state(
        p, JaxStrategy(optimizer=optimizer)), params)
    for jmesh, axes in _meshes():
        for zero1 in (True, False):
            ref = jshd.opt_state_pspecs(
                opt, params, JaxStrategy(optimizer=optimizer, zero1=zero1),
                jmesh)
            mine = shd.opt_state_pspecs(
                opt, params, Strategy(optimizer=optimizer, zero1=zero1),
                axes)
            assert _same(ref, mine) > 0


def _paged_cache(cfg, slots=4, pages=17, page_size=16):
    """The serving engine's paged decode state as shapes: the pool, the
    page table, the cursors (and an enc-dec model's cross K/V)."""
    sds = jax.ShapeDtypeStruct
    pool = (cfg.num_layers, pages, page_size, cfg.num_kv_heads,
            cfg.head_dim)
    cache = {"kv": {"k": sds(pool, jnp.float32), "v": sds(pool, jnp.float32)},
             "ptab": sds((slots, 4), jnp.int32),
             "pos": sds((slots,), jnp.int32)}
    if cfg.arch_type == "audio":
        cache["xkv"] = jax.eval_shape(
            lambda: get_model(cfg).init_cache(cfg, slots, 1))["xkv"]
    return cache


@pytest.mark.parametrize("name", CONFIGS)
def test_cache_specs_match_reference(name):
    """``cache_pspecs`` on the family's dense cache at a batch that
    divides the data axis (8) and one that does not (3), at a length that
    divides the model axis (64: the sequence-sharding fallback where the
    KV heads do not) and one that does not (30), and on the paged pool of
    the families that take one."""
    cfg = _cfg(name)
    model = get_model(cfg)
    trees = [(jax.eval_shape(lambda b=b, n=n: model.init_cache(cfg, b, n)),
              b) for b in (8, 3) for n in (64, 30)]
    if cfg.arch_type in ("dense", "moe", "audio") and not cfg.sliding_window:
        trees.append((_paged_cache(cfg), 4))
    for jmesh, axes in _meshes():
        for cache, batch in trees:
            ref = jshd.cache_pspecs(cache, JaxStrategy(), jmesh, batch)
            mine = shd.cache_pspecs(cache, Strategy(), axes, batch)
            assert _same(ref, mine) > 0


def test_zero1_spec_matches_reference():
    """``zero1_spec`` on 200 random shapes of 1-3 dims of sizes 1-8 a
    mesh, each dim's entry drawn from None, "model", "data" and ("data",
    "model")."""
    rng = np.random.default_rng(0)
    choices = (None, "model", "data", ("data", "model"))
    for jmesh, axes in _meshes():
        for _ in range(200):
            nd = int(rng.integers(1, 4))
            shape = tuple(int(s) for s in rng.integers(1, 9, size=nd))
            entries = [choices[int(i)] for i in rng.integers(0, 4, size=nd)]
            ref = jshd.zero1_spec(PartitionSpec(*entries), shape, jmesh)
            mine = shd.zero1_spec(P(*entries), shape, axes)
            assert tuple(mine) == tuple(ref), (shape, entries)


def test_megatron_column_row_pattern():
    """tests/test_sharding_rules.py:36 in the port's tables: wq / w_gate
    column-split, wo / w_down row-split, the embedding vocab-split."""
    specs = shd.param_pspecs(_params("qwen3-14b"), Strategy(),
                             {"data": 2, "model": 4})
    lp = specs["layers"]
    assert lp["attn"]["wq"] == P(None, None, "model")
    assert lp["attn"]["wo"] == P(None, "model", None)
    assert lp["mlp"]["w_gate"] == P(None, None, "model")
    assert lp["mlp"]["w_down"] == P(None, "model", None)
    assert specs["embed"] == P("model", None)


def test_moe_expert_parallel_specs():
    """tests/test_sharding_rules.py:51: experts over "model", or TP
    inside each expert."""
    params = _params("olmoe-1b-7b")
    axes = {"data": 2, "model": 4}
    ep = shd.param_pspecs(params, Strategy(expert_parallel=True), axes)
    assert ep["layers"]["moe"]["w_gate"] == P(None, "model", None, None)
    tp = shd.param_pspecs(params, Strategy(expert_parallel=False), axes)
    assert tp["layers"]["moe"]["w_gate"] == P(None, None, None, "model")


def test_cache_specs_fallback_to_seq_sharding():
    """tests/test_sharding_rules.py:93: qwen3-smoke's 2 KV heads cannot
    split over model 4, so the dense cache shards its sequence dim."""
    cfg = get_smoke("qwen3-14b")
    cache = jax.eval_shape(lambda: get_model(cfg).init_cache(cfg, 8, 64))
    specs = shd.cache_pspecs(cache, Strategy(), {"data": 2, "model": 4}, 8)
    spec = specs["kv"]["k"]
    assert spec[2] == "model" and spec[3] is None


def test_logical_to_spec_reads_the_active_rules():
    """core/pspec.py: without active rules every logical axis maps to
    None; under ``sharding_rules`` the table's entries, as the
    reference's ``logical_to_spec`` gives them; the accessors restore on
    exit."""
    from repro.core import pspec as jpspec
    from repro_torch.core import pspec
    axes = {"data": 2, "model": 4}
    logical = ("batch", "seq", "heads", "d_ff", None)
    want = jpspec.logical_to_spec(
        logical, JaxStrategy().rules(jax_mesh((2, 4), ("data", "model"))))
    assert pspec.logical_to_spec(logical) == P(*[None] * len(logical))
    with pspec.sharding_rules(axes, Strategy().rules(axes)):
        assert tuple(pspec.logical_to_spec(logical)) == tuple(want)
        assert pspec._mesh() == axes
    assert pspec._rules() is None and pspec._mesh() is None


# ------------------------------------------- Mamba2 blocks laid out by head

@pytest.mark.parametrize("name", ["mamba2-780m", "zamba2-1.2b"])
@pytest.mark.parametrize("shape", SHAPES)
def test_mamba_blocks_by_head_reassemble(name, shape):
    """The table still splits ``in_proj`` / ``conv_w`` / ``conv_b``
    contiguously, as the reference's does (``param_pspecs``); the port's
    rank spec (``core/tp.py::rank_pspecs``) lays the dim out by head: each
    rank's block is ``[z_r | x_r | B | C | dt_r]`` (the conv ``[x_r | B |
    C]``) of the full leaf, and the blocks of the ranks along "model"
    reassemble it: z, x and dt in rank order, B and C once."""
    from repro_torch.configs import get_smoke as port_smoke
    from repro_torch.core import tp
    from repro_torch.params import full_shapes
    cfg = port_smoke(name)
    data, model = shape
    axes = {"data": data, "model": model}
    st = Strategy()
    specs = tp.leaf_specs(full_shapes(cfg), st, axes, cfg)
    from repro_torch.tree import flatten, unflatten
    table = flatten(shd.param_pspecs(unflatten(
        {k: tp.Shape(s) for k, s in full_shapes(cfg).items()}), st, axes))
    din, n, h = cfg.ssm_heads * cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_heads
    for key, full in full_shapes(cfg).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf not in tp.SEGMENTED_LEAVES:
            continue
        assert tuple(table[key])[-1] == "model"      # the flat split
        spec = specs[key]
        assert isinstance(spec[-1], tp.Segmented)
        x = torch.arange(int(np.prod(full)), dtype=torch.float64) \
            .reshape(full)
        blocks = [tp.shard_leaf(x, spec, axes, {"data": 0, "model": r})
                  for r in range(model)]
        hr, dr = h // model, din // model
        for r, b in enumerate(blocks):
            assert b.shape == tp.local_shape(full, spec, axes)
            if leaf == "in_proj":
                parts = [x[..., r * dr:(r + 1) * dr],
                         x[..., din + r * dr:din + (r + 1) * dr],
                         x[..., 2 * din:2 * din + 2 * n],
                         x[..., 2 * din + 2 * n + r * hr:
                           2 * din + 2 * n + (r + 1) * hr]]
            else:
                parts = [x[..., r * dr:(r + 1) * dr], x[..., din:]]
            assert torch.equal(b, torch.cat(parts, dim=-1)), (key, r)
        # reassembled: each rank's split segments at its offsets, the
        # replicated ones from the first rank
        got = torch.zeros_like(x)
        for r, b in enumerate(blocks):
            at = 0
            for start, length, split in spec[-1].runs(model, r):
                if split or r == 0:
                    got[..., start:start + length] = b[..., at:at + length]
                at += length
        assert torch.equal(got, x), key


@pytest.mark.parametrize("model", [2, 4])
def test_once_counts_replicated_segments_once(model):
    """``core/tp.py::once``: summed over the ranks of "model", the squares
    of each rank's ``in_proj`` block with its B/C columns zeroed on every
    rank but the first equal the full leaf's (the global grad norm and
    Adafactor's sums); the blocks as they are count B and C once a
    rank."""
    from repro_torch.configs import get_smoke as port_smoke
    from repro_torch.core import tp
    cfg = port_smoke("mamba2-780m")
    seg = tp.Segmented("model", tp.ssm_segments(cfg, "in_proj"))
    spec = P(None, None, seg)
    axes = {"model": model}
    width = sum(n for n, _ in seg.segments)
    x = torch.randn((2, 8, width), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    once, plain = 0.0, 0.0
    for r in range(model):
        rank = tp.Rank(tp=model, rank=r, group=None, root=0, heads=0,
                       kv_heads=0, kv_read=None, axes=axes)
        block = tp.shard_leaf(x, spec, axes, {"model": r})
        kept = block.clone()
        once += float((tp.once(block, spec, rank) ** 2).sum())
        plain += float((block ** 2).sum())
        assert torch.equal(block, kept)          # the block is not changed
    din, n = cfg.ssm_heads * cfg.ssm_head_dim, cfg.ssm_state
    bc = float((x[..., 2 * din:2 * din + 2 * n] ** 2).sum())
    assert once == pytest.approx(float((x ** 2).sum()), rel=1e-12)
    assert plain == pytest.approx(float((x ** 2).sum()) + (model - 1) * bc,
                                  rel=1e-12)
