"""The port's kernel modules against the JAX package (repro_torch/kernels).

On the CPU each wrapper takes its plain PyTorch version — the contract the
CUDA kernel is held to on the card (chip_smoke.py, and the ``gpu``-marked
tests of tests/test_torch_gpu.py). Here the plain versions are held against the JAX gather path
and the Pallas kernels in interpret mode, on the same numpy inputs:
paged attention on the permuted / fragmented / poisoned tables of
tests/test_serve_pallas.py at 2e-5 (poisoning bitwise), the fused MLP
against ``ops.fused_mlp``, ``ref.fused_mlp_ref`` and ``layers.mlp`` at
1e-5, ragged T included; flash attention against ``ops.flash_attention``
(the Pallas kernel in interpret mode, 64-row blocks) at 2e-6 for the
forward (tests/test_kernels.py:33) and its custom VJP at 2e-5 / 2e-4
(tests/test_kernels.py:173) for the gradients.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_mlp as fm  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402
from repro_torch.models import layers  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand_paged(rng, *, b, width, n_pages, page_size, hq, hkv, d):
    """tests/test_serve_pallas.py::_rand_paged: permuted, fragmented page
    ids, page 0 the null page, cursors landing mid-page."""
    kp = rng.standard_normal((n_pages, page_size, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages, page_size, hkv, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    tab = np.zeros((b, width), np.int32)
    pos = np.zeros((b,), np.int32)
    k = 0
    for r in range(b):
        n_blk = r % width + 1
        tab[r, :n_blk] = perm[k:k + n_blk]
        k += n_blk
        pos[r] = (n_blk - 1) * page_size + int(rng.integers(0, page_size))
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    return q, kp, vp, tab, pos


def _both(q, kp, vp, tab, pos):
    """Port plain version, JAX gather, Pallas kernel (interpret mode)."""
    got = pa.paged_attention(_t(q), _t(kp), _t(vp), _t(tab), _t(pos))
    gather = jlayers.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                     jnp.asarray(vp), jnp.asarray(tab),
                                     jnp.asarray(pos), backend="gather")
    pallas = ops.paged_attention(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(tab),
                                 jnp.asarray(pos))
    return got.numpy(), np.asarray(gather), np.asarray(pallas)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_paged_attention_plain_matches_jax_on_fragmented_tables(hq, hkv):
    rng = np.random.default_rng(0)
    args = _rand_paged(rng, b=4, width=4, n_pages=16, page_size=8, hq=hq,
                       hkv=hkv, d=32)
    before = pa.paged_attention.launches
    got, gather, pallas = _both(*args)
    assert got.shape == (4, 1, hq, 32)
    np.testing.assert_allclose(got, gather, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=2e-5)
    # a CPU tensor takes the plain version: no kernel launch counted
    assert pa.paged_attention.launches == before


def test_paged_attention_plain_masks_poisoned_pages_bitwise():
    """test_serve_pallas.py:105 — page 0, every unreferenced page and each
    row's positions past its cursor hold 1e9: the output is bit-for-bit
    unchanged, and still matches the JAX gather and Pallas kernel."""
    rng = np.random.default_rng(1)
    q, kp, vp, tab, pos = _rand_paged(rng, b=3, width=4, n_pages=16,
                                      page_size=4, hq=4, hkv=4, d=16)
    clean = pa.paged_attention(_t(q), _t(kp), _t(vp), _t(tab), _t(pos))
    live = np.unique(tab)
    poison = np.setdiff1d(np.arange(16), live[live > 0])
    kp[poison] = 1e9
    vp[poison] = 1e9
    for r in range(3):
        last = int(tab[r, int(pos[r]) // 4])
        kp[last, int(pos[r]) % 4 + 1:] = 1e9
        vp[last, int(pos[r]) % 4 + 1:] = 1e9
    dirty, gather, pallas = _both(q, kp, vp, tab, pos)
    np.testing.assert_array_equal(clean.numpy(), dirty)
    np.testing.assert_allclose(dirty, gather, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(dirty, pallas, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (5, 1)])
def test_paged_attention_plain_f32p_is_the_pallas_arithmetic_in_bf16(hq, hkv):
    """bf16 inputs: the plain version that keeps P fp32 (what the bf16 CUDA
    kernel is held to per value on the card) gives the Pallas kernel's
    values (interpret mode), while the gather plain version, which rounds
    P to bf16 first, is many bf16 ulps away."""
    rng = np.random.default_rng(3)
    q, kp, vp, tab, pos = _rand_paged(rng, b=5, width=4, n_pages=20,
                                      page_size=8, hq=hq, hkv=hkv, d=32)
    bf = jnp.bfloat16
    pallas = np.asarray(ops.paged_attention(
        jnp.asarray(q, bf), jnp.asarray(kp, bf), jnp.asarray(vp, bf),
        jnp.asarray(tab), jnp.asarray(pos)).astype(jnp.float32))
    args = [_t(a).to(torch.bfloat16) for a in (q, kp, vp)] + \
        [_t(tab), _t(pos)]
    limit = 1e-5 + 8e-3 * np.abs(pallas)
    got = pa.paged_attention_plain_f32p(*args).float().numpy()
    assert (np.abs(got - pallas) <= limit).all()
    gather = pa.paged_attention_plain(*args).float().numpy()
    assert (np.abs(gather - pallas) > limit).any()


def test_paged_tile_sizes_and_splits():
    """Rows a tile fill the 64 M rows of a wgmma with whole rows of rep
    query heads; a tile splits past one 256-key segment (4 kv tiles of 64
    keys) of its last row into one work item a segment, with no cap on
    the count; ``segments`` are fixed in absolute keys."""
    assert [pa.rows_per_tile(r) for r in (1, 4, 5, 8, 16)] == [64, 16, 12,
                                                                8, 4]
    want = {0: (1, 0), 1: (1, 1), 4: (1, 4), 5: (2, 4), 8: (2, 4),
            9: (3, 4), 12: (3, 4), 16: (4, 4), 17: (5, 4), 64: (16, 4)}
    for n_tiles, split in want.items():
        assert pa.split_tiles(n_tiles) == split
        count, per = split
        assert n_tiles == 0 or (count - 1) * per < n_tiles <= count * per
    assert pa.segments(0) == []
    assert pa.segments(255) == [(0, 255)]
    assert pa.segments(256) == [(0, 256)]
    assert pa.segments(257) == [(0, 256), (256, 257)]
    assert pa.segments(700) == [(0, 256), (256, 512), (512, 700)]
    assert len(pa.segments(4096)) == 16


def _slot_tables(ctx, width=64, page_size=16, seed=0):
    perm = np.random.default_rng(seed).permutation(np.arange(1, 1 + sum(
        -(-n // page_size) for n in ctx)))
    tables = np.zeros((len(ctx), width), np.int32)
    k = 0
    for slot, n in enumerate(ctx):
        blocks = -(-n // page_size)
        tables[slot, :blocks] = perm[k:k + blocks]
        k += blocks
    return tables


def test_tile_plan_on_the_serving_mixes():
    """Phase 5's mixes (Qwen3-14B, rep 5, 16-token pages): decode rows of
    different slots never share a tile, and each splits into its 256-key
    segments (716, 300, 520 keys: 3, 2, 3); the 253 rows of a prefill
    chunk past 256 keys share 21 tiles of 12 rows and one lone row, each
    split into its 2 segments, so every row's own segments go through the
    combine; the 252 padding rows of a decode-only step (slot 0, pos 0)
    take 21 whole tiles of one page each, written directly; a lone
    4096-key row splits into 16 segments."""
    tables = _slot_tables((716, 300, 520, 640))
    slots = [0, 1, 2] + [3] * 253
    items, fold = pa.tile_plan(tables[slots], [715, 299, 519]
                               + list(range(256, 509)), 16, 5)
    decode = [(0, 1, s) for s in range(3)] + [(1, 1, s) for s in range(2)] \
        + [(2, 1, s) for s in range(3)]
    assert items[:8] == decode
    assert items[8:50] == [(3 + 12 * (i // 2), 12, i % 2)
                           for i in range(42)]
    assert items[50:] == [(255, 1, 0), (255, 1, 1)]
    assert list(fold[:4]) == [3, 2, 3, 2] and (fold[3:] == 2).all()
    slots = [0, 1, 2, 3] + [0] * 252
    items, fold = pa.tile_plan(tables[slots],
                               [715, 299, 519, 639] + [0] * 252, 16, 5)
    assert [it for it in items if it[0] >= 4] == [(4 + 12 * i, 12, -1)
                                                  for i in range(21)]
    assert len(items) == 11 + 21
    assert list(fold[:4]) == [3, 2, 3, 3] and (fold[4:] == -1).all()
    # a lone 4096-key decode row: one item a 256-key segment, 16 of them
    items, fold = pa.tile_plan(np.arange(1, 257, dtype=np.int32)[None],
                               [4095], 16, 5)
    assert items == [(0, 1, s) for s in range(16)] and fold[0] == 16


def test_tile_plan_never_shares_a_tile_across_tables():
    """A tile straddling two slots is cut at the slot change; rows whose
    tables agree on their first pages only share a tile just when the
    earlier row's live pages are among those (then it reads the later
    row's table, which agrees with its own over its live pages)."""
    tables = _slot_tables((716, 300, 520, 640))
    items, _ = pa.tile_plan(tables[[2] * 7 + [3] * 9],
                            list(range(100, 107)) + list(range(200, 209)),
                            16, 5)
    assert items == [(0, 7, -1), (7, 9, -1)]
    tables = _slot_tables((716, 716))
    tables[1, :5] = tables[0, :5]
    items, fold = pa.tile_plan(tables[[0, 1, 0, 1]], [300, 400, 70, 400],
                               16, 5)
    assert items == [(0, 1, 0), (0, 1, 1), (1, 1, 0), (1, 1, 1), (2, 2, 0),
                     (2, 2, 1)]
    assert list(fold) == [2, 2, 1, 2]


@pytest.mark.parametrize("seed", range(4))
def test_tile_plan_rows_read_only_their_own_pages(seed):
    """Random rows over random fragmented tables, some sharing a slot's
    table and some a prefix of it: every row of a tile agrees with the
    tile's last row (whose table the tile reads) over its own live pages,
    no tile exceeds its row count, every row lies in exactly one tile,
    covered once by a whole item or by each of its tile's segment items,
    and a row of a split tile has its own segment count to fold."""
    rng = np.random.default_rng(seed)
    tables = _slot_tables((900, 900, 400, 64), seed=seed)
    tables[1, :7] = tables[0, :7]     # slot 1 shares slot 0's first pages
    b = 200
    slots = rng.integers(0, 4, size=b)
    if seed % 2:                      # runs of one slot, as the engine packs
        slots = np.sort(slots)
    pos = rng.integers(0, 1024, size=b).astype(np.int32)
    if seed >= 2:                     # cursors rising along the rows
        pos = np.sort(pos)
    tab = tables[slots]
    rep = int(rng.choice([1, 4, 5, 8]))
    items, fold = pa.tile_plan(tab, pos, 16, rep)
    kv = np.clip(pos + 1, 0, 1024)
    live = -(-kv // 16)
    covered, tiles = np.zeros(b, np.int64), {}
    for row0, n_rows, split in items:
        last = row0 + n_rows - 1
        assert 1 <= n_rows <= pa.rows_per_tile(rep)
        assert (split == -1) == (-(-kv[last] // 256) <= 1)
        for r in range(row0, row0 + n_rows):
            assert (tab[r, :live[r]] == tab[last, :live[r]]).all()
            assert live[r] <= live[last]
            covered[r] += 1
            tiles.setdefault(r, set()).add(row0)
    assert all(len(t) == 1 for t in tiles.values()) and len(tiles) == b
    for r in range(b):
        if fold[r] < 0:
            assert covered[r] == 1
        else:
            assert fold[r] == len(pa.segments(int(kv[r])))
            assert covered[r] >= max(fold[r], 2)


@settings(max_examples=80, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), rep=st.sampled_from([1, 4, 5, 8,
                                                              16]),
       b=st.integers(1, 80), runs=st.booleans())
def test_tile_plan_segments_depend_on_own_kv_len(seed, rep, b, runs):
    """Over random tables (slots sharing first pages, as prefix hits do),
    cursors and rep: the key segments each row accumulates under the
    plan's items, in order, are ``segments`` of its own kv_len — whether
    it is lone, in a run of its slot's rows or in a tile beside another
    slot's — and the combine folds exactly those (a whole item's row has
    one)."""
    rng = np.random.default_rng(seed)
    tables = _slot_tables((1300, 1300, 700, 300), width=96, seed=seed % 7)
    share = int(rng.integers(1, 60))
    tables[1, :share] = tables[0, :share]
    slots = rng.integers(0, 4, size=b)
    pos = rng.integers(0, 1536, size=b).astype(np.int32)
    if runs:                          # a slot's rows together, rising
        order = np.lexsort((pos, slots))
        slots, pos = slots[order], pos[order]
    tab = tables[slots]
    items, fold = pa.tile_plan(tab, pos, 16, rep)
    got = pa.row_segments(items, pos, 16, tab.shape[1])
    kv = np.clip(pos.astype(np.int64) + 1, 0, tab.shape[1] * 16)
    for r in range(b):
        assert got.get(r, []) == pa.segments(int(kv[r])), r
        # the combine folds exactly those segments; a whole item's row has
        # at most one
        assert fold[r] == len(got.get(r, [])) if fold[r] >= 0 \
            else len(got.get(r, [])) <= 1


@pytest.mark.parametrize("t,d,f", [(128, 64, 256), (256, 128, 512),
                                   (40, 64, 128)])
def test_fused_mlp_plain_matches_jax(t, d, f):
    """(40, 64, 128) is a ragged T: no multiple of the reference's
    default block."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((t, d)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.05).astype(np.float32)
          for s in ((d, f), (d, f), (f, d))]
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(_t(x), *map(_t, ws)).numpy()
    jx, jws = jnp.asarray(x), [jnp.asarray(w) for w in ws]
    np.testing.assert_allclose(got, np.asarray(ops.fused_mlp(jx, *jws)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref.fused_mlp_ref(jx, *jws)),
                               atol=1e-5, rtol=1e-5)
    p = {"w_gate": jws[0], "w_up": jws[1], "w_down": jws[2]}
    np.testing.assert_allclose(got, np.asarray(jlayers.mlp(p, jx)),
                               atol=1e-5, rtol=1e-5)
    assert fm.fused_mlp.launches == before


def test_fused_mlp_keeps_leading_axes_and_rounds_h_to_wd_dtype():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 5, 16)).astype(np.float32))
    ws = [torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32))
          for s in ((16, 24), (16, 24), (24, 16))]
    y = fm.fused_mlp(x, *ws)
    assert y.shape == (2, 5, 16)
    np.testing.assert_allclose(
        y.reshape(10, 16).numpy(),
        fm.fused_mlp_plain(x.reshape(10, 16), *ws).numpy(), atol=0, rtol=0)
    # bf16 down-projection weight: h is rounded to bf16 before it
    wd16 = ws[2].to(torch.bfloat16)
    y16 = fm.fused_mlp_plain(x.reshape(10, 16), ws[0], ws[1], wd16)
    h = (torch.nn.functional.silu(x.reshape(10, 16) @ ws[0])
         * (x.reshape(10, 16) @ ws[1])).to(torch.bfloat16)
    np.testing.assert_allclose(y16.numpy(), (h.float() @ wd16.float()).numpy(),
                               atol=1e-6)


def test_fused_mlp_never_returns_a_graphless_output_when_grad_is_needed():
    """The kernel pair writes through raw pointers: on a grad-requiring
    input its CUDA entry raises (before any device check), and the
    model's MLP takes the plain matmul SwiGLU, whose gradients are the
    reference's."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 6, 32)).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((32, 48), (32, 48), (48, 32))]
    tw = [_t(w).requires_grad_(True) for w in ws]
    with pytest.raises(RuntimeError, match="layers.mlp"):
        fm.fused_mlp_cuda(_t(x).reshape(12, 32), *tw)
    y = fm.fused_mlp(_t(x), *tw)           # CPU plain version: a graph
    assert y.grad_fn is not None
    p = dict(zip(("w_gate", "w_up", "w_down"), tw))
    out = layers.mlp(p, _t(x))
    assert out.grad_fn is not None
    grads = torch.autograd.grad((out ** 2).mean(), tw)
    jp = dict(zip(("w_gate", "w_up", "w_down"), map(jnp.asarray, ws)))
    jgrads = jax.grad(lambda q: (jlayers.mlp(q, jnp.asarray(x)) ** 2)
                      .mean())(jp)
    for name, g in zip(("w_gate", "w_up", "w_down"), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[name]),
                                   atol=1e-6, rtol=1e-5)
    with torch.no_grad():                  # serving: the fused path
        np.testing.assert_allclose(layers.mlp(p, _t(x)).numpy(),
                                   out.detach().numpy(), atol=1e-5)


# (B, S, T, Hq, Hkv, D, causal, window): causal, window, non-causal,
# GQA, ragged S < T and S > T (no multiple of the 64-row block)
FLASH_CASES = {
    "causal": (2, 128, 128, 2, 2, 32, True, 0),
    "window": (1, 128, 128, 2, 2, 32, True, 40),
    "noncausal": (2, 128, 128, 2, 2, 32, False, 0),
    "gqa": (2, 128, 128, 8, 2, 16, True, 0),
    "ragged": (1, 100, 77, 4, 2, 16, True, 0),
    "ragged_noncausal_window": (1, 70, 100, 4, 1, 16, False, 24),
}


def _flash_inputs(case, seed=0):
    b, s, t, hq, hkv, d, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    return q, k, v, dict(causal=causal, window=window)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_plain_matches_jax_kernel(case):
    q, k, v, kw = _flash_inputs(case)
    before = fa.flash_attention.launches
    got = fa.flash_attention(_t(q), _t(k), _t(v), **kw)
    want = ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), block_q=64, block_k=64, **kw)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)
    assert fa.flash_attention.launches == before
    # the port of the MHA oracle, on KV repeated to Hq heads
    rep = q.shape[2] // k.shape[2]
    oracle = ref.flash_attention_ref(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), rep, axis=2),
        jnp.repeat(jnp.asarray(v), rep, axis=2), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=2e-6,
                               rtol=2e-6)


@pytest.mark.parametrize("case", ["causal", "window", "gqa", "ragged"])
def test_flash_attention_grads_match_jax_custom_vjp(case):
    """The autograd.Function's backward (the port of ``_flash_bwd``)
    against the reference's custom VJP, and against autograd through the
    plain version."""
    q, k, v, kw = _flash_inputs(case, seed=1)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    got = torch.autograd.grad(
        (fa.flash_attention(tq, tk, tv, **kw) ** 2).mean(), (tq, tk, tv))
    want = jax.grad(lambda a, b, c: (ops.flash_attention(
        a, b, c, block_q=64, block_k=64, **kw) ** 2).mean(),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    plain = torch.autograd.grad(
        (fa.flash_attention_plain(tq, tk, tv, **kw) ** 2).mean(),
        (tq, tk, tv))
    for g, w, pl in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-4)
        np.testing.assert_allclose(g.numpy(), pl.numpy(), atol=2e-5,
                                   rtol=2e-4)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No fallback: with no compiler the build raises instead of quietly
    handing a CUDA tensor to the plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("paged_attention")


def test_build_key_covers_source_and_flags(monkeypatch, tmp_path):
    """The library name hashes the source and the flags, so an edited
    source never loads a stale build."""
    a = build._target("fused_mlp")
    assert a.parent == build.BUILD_DIR and a.suffix == ".so"
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build._target("fused_mlp") != a
    assert build._target("paged_attention") != a
    assert build._target("flash_attention") != a


def test_build_key_covers_shared_headers(monkeypatch, tmp_path):
    """A kernel that includes a shared header (csrc/hopper.cuh) rebuilds
    when only the header changes; a copy of csrc stands in for the repo's,
    which is never written."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in ("fused_mlp.cu", "hopper.cuh"):
        (csrc / f).write_bytes((build.CSRC / f).read_bytes())
    assert '#include "hopper.cuh"' in (csrc / "fused_mlp.cu").read_text()
    monkeypatch.setattr(build, "CSRC", csrc)
    a = build._target("fused_mlp")
    assert build._target("fused_mlp") == a
    (csrc / "hopper.cuh").write_text((csrc / "hopper.cuh").read_text()
                                     + "\n// edited\n")
    b = build._target("fused_mlp")
    assert b != a and b.parent == a.parent
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build._target("fused_mlp") != b


def test_mlp_plan_fills_the_sms_in_whole_waves():
    """The bf16 MLP's split plan: at the serving shape (T = 256, d = 5120,
    f = 17408, 132 SMs) gate/up has 272 units, two full waves and 8 left,
    which split in K 16 ways; the down GEMM's 40 units split 3 ways. No
    split where the units fill whole waves or a split would not pay."""
    assert fm.mlp_plan(256, 5120, 17408, 132) == (3, 8, 16, 8 * 16 * 2
                                                  * 128 * 128)
    assert fm.mlp_plan(256, 5120, 16896, 132) == (3, 0, 1, 3 * 256 * 5120)
    assert fm.mlp_plan(70, 256, 520, 132) == (8, 0, 1, 8 * 70 * 256)
    assert fm.mlp_plan(16, 64, 100, 132) == (2, 0, 1, 2 * 16 * 64)
    # 4096 rows: 4352 gate/up units (32 full waves and 128 left, too many
    # to split), 640 down units: no split at all
    assert fm.mlp_plan(4096, 5120, 17408, 132) == (1, 0, 1, 0)
    # 134 units of 70 ragged rows, the last one 40 columns wide: 2 left
    assert fm.mlp_plan(70, 256, 17064, 132) == (8, 2, 4, 2 * 4 * 2 * 128
                                                 * 128)
    assert fm.mlp_plan(0, 5120, 17408, 132) == (8, 0, 1, 0)


def test_ssd_pass_grids_are_parallel_over_chunks_and_heads():
    """The SSD kernel's four launches at the serving prefill (b 1, s 1024,
    h 48, p 64, n 128, chunk 128): C·Bᵀ per (chunk, 32 x 32 tile), chunk
    states and chunk scan per (chunk, head) — 384 blocks for 132 SMs,
    where one block per (batch, head) gave 48 — and state passing per
    (head, 1024 state elements). A ragged single chunk keeps its rows."""
    assert sk.pass_grids(1, 1024, 48, 64, 128, 128) == {
        "prep": 8 * 16, "state": 8 * 48, "pass": 48 * 8,
        "chunk_scan": 8 * 48}
    assert sk.pass_grids(2, 77, 3, 24, 20, 128) == {
        "prep": 2 * 9, "state": 2 * 3, "pass": 2 * 3, "chunk_scan": 6}
    with pytest.raises(ValueError, match="precondition"):
        sk.pass_grids(1, 200, 2, 16, 16, 128)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel entry points take CUDA tensors only; they check before
    any build or launch."""
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fm.fused_mlp_cuda(x, torch.zeros((8, 16)), torch.zeros((8, 16)),
                          torch.zeros((16, 8)))
    q = torch.zeros((2, 1, 4, 16))
    kp = torch.zeros((3, 4, 2, 16))
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention_cuda(q, kp, kp, torch.zeros((2, 2), dtype=torch.int32),
                                torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(torch.zeros((1, 8, 4, 16)),
                                torch.zeros((1, 8, 2, 16)),
                                torch.zeros((1, 8, 2, 16)))
