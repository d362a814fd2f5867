"""The port's kernel modules against the JAX package (repro_torch/kernels).

On the CPU each wrapper takes its plain PyTorch version — the contract the
CUDA kernel is held to on the card (chip_smoke.py, and the ``gpu``-marked
tests of tests/test_torch_gpu.py). Here the plain versions are held against the JAX gather path
and the Pallas kernels in interpret mode, on the same numpy inputs:
paged attention on the permuted / fragmented / poisoned tables of
tests/test_serve_pallas.py at 2e-5 (poisoning bitwise), the fused MLP
against ``ops.fused_mlp``, ``ref.fused_mlp_ref`` and ``layers.mlp`` at
1e-5, ragged T included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops, ref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import fused_mlp as fm  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402


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
