"""The port's CUDA kernels and engine on the card (``gpu`` marker).

On a machine with an NVIDIA GPU and ``nvcc``:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because the suite's conftest imports jax, which the
card's machine need not have: this file imports only torch, numpy and the
port.) Without a card every test skips inside its fixture, so every
pytest worker collects the same tests.

Tolerances: fp32 kernels against their plain versions at 2e-5 (paged
attention, another summation order and ``expf``), 2e-6 (flash attention,
tests/test_kernels.py:33) and 1e-5 (fused MLP); bf16 at 2e-2 for paged
attention (the plain version rounds the softmax probs to bf16 where the
kernel keeps them fp32, and bf16 has 8 bits of mantissa), at atol 1e-5 /
rtol 8e-3 for flash attention (both sides compute in fp32 and round the
output once: one bf16 ulp), and at atol 1e-3 / rtol 8e-3 for the fused
MLP (one ulp of the output, plus h's bf16 rounding flips: the two sum
x.Wg and x.Wu in other orders; chip_smoke.py::phase_mlp prints the atol
a correct kernel needs at the serving shape); flash gradients at
2e-5 / 2e-4
(tests/test_kernels.py:173); a train step card vs CPU at 1e-4; the SSD
scan's y at 1e-4 in fp32 (tests/test_kernels.py:118) and at atol 1e-5 /
rtol 8e-3 in bf16 (both sides compute in fp32 from the same bf16 inputs
and round y once), its final state at atol 1e-5 / rtol 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_mlp as fm  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssd_scan as sk  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.core.strategy import Strategy  # noqa: E402
from repro_torch.train import step  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run with -m gpu on the machine "
                    "with the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _paged(rng, *, b, width, n_pages, page_size, hq, hkv, d, dtype):
    """Permuted, fragmented page tables, page 0 the null page, cursors
    landing mid-page (tests/test_serve_pallas.py::_rand_paged)."""
    perm = rng.permutation(np.arange(1, n_pages))
    tab = np.zeros((b, width), np.int32)
    pos = np.zeros((b,), np.int32)
    k = 0
    for r in range(b):
        n_blk = r % width + 1
        tab[r, :n_blk] = perm[k:k + n_blk]
        k += n_blk
        pos[r] = (n_blk - 1) * page_size + int(rng.integers(0, page_size))
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, 1, hq, d), (n_pages, page_size, hkv, d),
                      (n_pages, page_size, hkv, d))]
    q, kp, vp = (torch.from_numpy(a).cuda().to(dtype) for a in arrs)
    return q, kp, vp, torch.from_numpy(tab).cuda(), \
        torch.from_numpy(pos).cuda()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hq,hkv,d,page_size", [(8, 2, 32, 8),
                                                (40, 8, 128, 16)])
def test_paged_attention_kernel_matches_plain(cuda, dtype, tol, hq, hkv, d,
                                              page_size):
    rng = np.random.default_rng(hq)
    args = _paged(rng, b=6, width=5, n_pages=40, page_size=page_size, hq=hq,
                  hkv=hkv, d=d, dtype=dtype)
    before = pa.paged_attention.launches
    got = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == (6, 1, hq, d)
    torch.testing.assert_close(got.float(),
                               pa.paged_attention_plain(*args).float(),
                               atol=tol, rtol=tol)


def test_paged_attention_kernel_ignores_poisoned_pages_bitwise(cuda):
    """tests/test_serve_pallas.py:105 on the card: page 0, unreferenced
    pages and each row's positions past its cursor hold 1e9."""
    rng = np.random.default_rng(1)
    q, kp, vp, tab, pos = _paged(rng, b=3, width=4, n_pages=16, page_size=4,
                                 hq=4, hkv=4, d=16, dtype=torch.float32)
    clean = pa.paged_attention(q, kp, vp, tab, pos)
    live = set(tab.flatten().tolist()) - {0}
    poison = [p for p in range(16) if p not in live]
    kp[poison] = 1e9
    vp[poison] = 1e9
    for r in range(3):
        c = int(pos[r])
        last = int(tab[r, c // 4])
        kp[last, c % 4 + 1:] = 1e9
        vp[last, c % 4 + 1:] = 1e9
    assert torch.equal(clean, pa.paged_attention(q, kp, vp, tab, pos))


@pytest.mark.parametrize("hq,hkv,d,page_size", [(34, 2, 16, 4),   # rep 17
                                                (6, 4, 16, 4),    # Hq % Hkv
                                                (4, 2, 512, 4),   # D
                                                (4, 2, 16, 256)])  # page
def test_paged_attention_kernel_refuses_shapes_past_its_limits(
        cuda, hq, hkv, d, page_size):
    """The C entry checks the limits its shared-memory arrays are sized
    by and launches nothing past them."""
    rng = np.random.default_rng(0)
    args = _paged(rng, b=2, width=2, n_pages=6, page_size=page_size, hq=hq,
                  hkv=hkv, d=d, dtype=torch.float32)
    before = pa.paged_attention.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        pa.paged_attention(*args)
    assert pa.paged_attention.launches == before


# (atol, rtol); weight scales (w_gate and w_up, w_down): 0.05, or the
# model's init scales at the serving path's shape (Qwen3-14B, 40 layers)
@pytest.mark.parametrize("dtype,tol,t,d,f,scales", [
    (torch.float32, (1e-5, 1e-5), 37, 72, 100, (0.05, 0.05)),  # ragged
    (torch.float32, (1e-5, 1e-5), 128, 64, 256, (0.05, 0.05)),
    (torch.bfloat16, (1e-3, 8e-3), 70, 256, 520, (0.05, 0.05)),  # ragged
    # 134 gate/up units on 132 SMs: the last 2 (ragged) split in K
    (torch.bfloat16, (1e-3, 8e-3), 70, 256, 17064, (0.05, 0.05)),
    (torch.bfloat16, (1e-3, 8e-3), 256, 5120, 17408,
     (0.02, 0.02 / 80 ** 0.5)),
])
def test_fused_mlp_kernel_matches_plain(cuda, dtype, tol, t, d, f, scales):
    gen = torch.Generator(device="cuda").manual_seed(t)
    x = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
    ws = [(torch.randn(s, generator=gen, device="cuda") * sc).to(dtype)
          for s, sc in (((d, f), scales[0]), ((d, f), scales[0]),
                        ((f, d), scales[1]))]
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(x, *ws)
    assert fm.fused_mlp.launches == before + 1
    torch.testing.assert_close(got.float(),
                               fm.fused_mlp_plain(x, *ws).float(),
                               atol=tol[0], rtol=tol[1])
    # no float atomics: the same call gives the same bits
    assert torch.equal(got, fm.fused_mlp(x, *ws))


def test_engine_on_card_matches_cpu(cuda):
    """The f32 engine on the card gives the CPU's greedy streams, and
    every program run went through both kernels once a layer."""
    cfg = ModelConfig(name="pal-dense", arch_type="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=128, dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=3)

    def to_cuda(tree):
        return {k: to_cuda(v) if isinstance(v, dict) else v.cuda()
                for k, v in tree.items()}

    params = {"cpu": cpu, "cuda": to_cuda(cpu)}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, size=(n,)) for n in (5, 23, 9, 40, 6)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params[dev], slots=2, max_len=64,
                          chunk_tokens=16)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=6)
        kernels.reset_launches()
        res = eng.run()
        outs[dev] = {i: list(res[i].out) for i in res}
        runs = eng.stats["mixed_steps"]
        want = cfg.num_layers * runs if dev == "cuda" else 0
        assert kernels.launches() == {"paged_attention": want,
                                      "fused_mlp": want,
                                      "flash_attention": 0, "ssd_scan": 0}
        assert eng.stats["decode_backend"] == \
            ("kernel" if dev == "cuda" else "plain")
    assert outs["cpu"] == outs["cuda"]


# (B, S, T, Hq, Hkv, D, causal, window): causal, window, non-causal, GQA
# at the model's head width, ragged S < T and S > T
FLASH = [(2, 128, 128, 2, 2, 32, True, 0), (1, 200, 200, 4, 2, 64, True, 50),
         (2, 96, 96, 2, 1, 32, False, 0), (1, 256, 256, 10, 2, 128, True, 0),
         (1, 100, 77, 4, 2, 16, True, 0), (1, 70, 133, 4, 4, 64, False, 30)]


def _flash_args(shape, dtype, seed=0):
    b, s, t, hq, hkv, d, causal, window = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(dtype)
               for sh in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    return q, k, v, dict(causal=causal, window=window)


# (atol, rtol): bf16 at one bf16 ulp of each value (2^-7 of it at most),
# since kernel and plain both compute in fp32 and round the output once
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (2e-6, 2e-6)),
                                       (torch.bfloat16, (1e-5, 8e-3))])
@pytest.mark.parametrize("shape", FLASH)
def test_flash_attention_kernel_matches_plain(cuda, dtype, tol, shape):
    q, k, v, kw = _flash_args(shape, dtype)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(
        got.float(), fa.flash_attention_plain(q, k, v, **kw).float(),
        atol=tol[0], rtol=tol[1])


def test_flash_attention_kernel_writes_zero_for_rows_without_live_keys(cuda):
    """Non-causal window with S > T + window: query rows past
    T - 1 + window see no key; the kernel writes 0 there (``safe_l``)."""
    q, k, v, _ = _flash_args((1, 160, 64, 2, 2, 32, False, 0),
                             torch.float32)
    got = fa.flash_attention(q, k, v, causal=False, window=40)
    assert torch.equal(got[:, 103:], torch.zeros_like(got[:, 103:]))
    torch.testing.assert_close(
        got[:, :103], fa.flash_attention_plain(q, k, v, causal=False,
                                               window=40)[:, :103],
        atol=2e-6, rtol=2e-6)


# bf16 only: Kimi's head width (112) with causal GQA, and the training
# shape's heads (40/8 x 128) at S = T = 1024
FLASH_BF16 = [(1, 300, 300, 8, 2, 112, True, 0),
              (1, 1024, 1024, 40, 8, 128, True, 0)]


@pytest.mark.parametrize("shape", FLASH_BF16)
def test_flash_attention_bf16_kernel_matches_plain(cuda, shape):
    q, k, v, kw = _flash_args(shape, torch.bfloat16)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    torch.testing.assert_close(
        got.float(), fa.flash_attention_plain(q, k, v, **kw).float(),
        atol=1e-5, rtol=8e-3)


@pytest.mark.parametrize("d", [20, 136])
def test_flash_attention_bf16_kernel_refuses_head_dims_tma_cannot_take(
        cuda, d):
    """TMA needs 16-byte row strides (D % 8 == 0) and the kernel's D tile
    is at most 128: the bf16 entry launches nothing otherwise."""
    q, k, v, kw = _flash_args((1, 64, 64, 2, 2, d, True, 0), torch.bfloat16)
    before = fa.flash_attention.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa.flash_attention(q, k, v, **kw)
    assert fa.flash_attention.launches == before


def test_fused_mlp_bf16_kernel_refuses_f_not_a_multiple_of_8(cuda):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((16, 64), generator=gen, device="cuda").to(torch.bfloat16)
    ws = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
          for s in ((64, 100), (64, 100), (100, 64))]
    before = fm.fused_mlp.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        fm.fused_mlp(x, *ws)
    assert fm.fused_mlp.launches == before


def test_flash_attention_kernel_refuses_head_dim_past_its_limit(cuda):
    q, k, v, kw = _flash_args((1, 64, 64, 2, 2, 256, True, 0),
                              torch.float32)
    before = fa.flash_attention.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        fa.flash_attention(q, k, v, **kw)
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("shape", [FLASH[0], FLASH[1], FLASH[3], FLASH[4]])
def test_flash_attention_gradients_match_autograd_of_plain(cuda, shape):
    q, k, v, kw = _flash_args(shape, torch.float32, seed=1)
    leaves = [a.requires_grad_(True) for a in (q, k, v)]
    got = torch.autograd.grad((fa.flash_attention(*leaves, **kw) ** 2)
                              .mean(), leaves)
    want = torch.autograd.grad((fa.flash_attention_plain(*leaves, **kw)
                                ** 2).mean(), leaves)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-4)


def test_mlp_takes_the_plain_path_when_a_gradient_is_needed(cuda):
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((2, 6, 64), generator=gen, device="cuda")
    ws = [(torch.randn(s, generator=gen, device="cuda") * 0.05)
          .requires_grad_(True) for s in ((64, 96), (64, 96), (96, 64))]
    with pytest.raises(RuntimeError, match="layers.mlp"):
        fm.fused_mlp(x, *ws)
    p = dict(zip(("w_gate", "w_up", "w_down"), ws))
    before = fm.fused_mlp.launches
    out = layers.mlp(p, x)
    assert out.grad_fn is not None and fm.fused_mlp.launches == before
    grads = torch.autograd.grad(out.sum(), ws)
    assert all(g.abs().sum() > 0 for g in grads)
    with torch.no_grad():
        torch.testing.assert_close(layers.mlp(p, x), out, atol=1e-5,
                                   rtol=1e-5)
    assert fm.fused_mlp.launches == before + 1


def test_train_steps_on_card_match_cpu(cuda):
    """fp32, remat on, attn_impl="auto" (the flash kernel on the card,
    full attention on the CPU): the loss gradients at init, then two
    AdamW steps' losses, grad norms and params within 1e-4 of the CPU's;
    the kernel ran twice a layer a step (forward and the remat
    recompute). lr = 1e-5: an AdamW step moves a weight by about
    lr * sign(g), so a near-zero gradient whose sign differs between the
    devices costs 2e-5, inside the tolerance."""
    cfg = ModelConfig(name="pal-dense", arch_type="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=128, dtype="float32", qk_norm=True)
    strat = Strategy(dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=3)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 128, size=(2, 96)).astype(np.int32))
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev, copy=True), cpu)
        leaves = flatten(params)
        for t in leaves.values():
            t.requires_grad_(True)
        total, _ = step.make_loss_fn(cfg, strat)(
            params, {"tokens": tokens.to(dev)})
        grads = dict(zip(leaves, (g.cpu() for g in torch.autograd.grad(
            total, list(leaves.values())))))
        opt = step.init_opt_state(params, strat)
        train_step = step.make_train_step(cfg, strat, lr=1e-5)
        kernels.reset_launches()
        mets = []
        for _ in range(2):
            params, opt, m = train_step(params, opt,
                                        {"tokens": tokens.to(dev)})
            mets.append({k: float(v) for k, v in m.items()})
        want = 2 * cfg.num_layers * 2 if dev == "cuda" else 0
        assert kernels.launches()["flash_attention"] == want
        assert kernels.launches()["fused_mlp"] == 0
        out[dev] = (mets, {k: v.detach().cpu()
                           for k, v in flatten(params).items()}, grads)
    for key, g in out["cpu"][2].items():
        torch.testing.assert_close(out["cuda"][2][key], g, atol=1e-4,
                                   rtol=1e-4)
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        assert a["loss"] == pytest.approx(b["loss"], abs=1e-4)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], abs=1e-4)
    for key, p in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][key], p, atol=1e-4,
                                   rtol=1e-4)


def _ssd_args(shape, dtype, seed=0, strided=False):
    """x, dt, A, B, C at tests/test_kernels.py's scales. ``strided``: x,
    B and C are views into one (b, s, h*p + 2n) buffer, as mamba_forward
    hands them over."""
    b, s, h, p, n = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*sh):
        return torch.randn(sh, generator=gen, device="cuda")

    dt = torch.nn.functional.softplus(rnd(b, s, h))
    A = -torch.exp(rnd(h))
    if strided:
        buf = torch.cat([rnd(b, s, h * p) * 0.5, rnd(b, s, 2 * n) * 0.3],
                        dim=-1).to(dtype)
        x = buf[..., :h * p].reshape(b, s, h, p)
        return x, dt, A, buf[..., h * p:h * p + n], buf[..., h * p + n:]
    return ((rnd(b, s, h, p) * 0.5).to(dtype), dt, A,
            (rnd(b, s, n) * 0.3).to(dtype), (rnd(b, s, n) * 0.3).to(dtype))


# (b, s, h, p, n, chunk): the reference's sweep, one ragged chunk (q = 77),
# several chunks, a ragged p and n, the serving path's head
SSD = [(2, 128, 2, 32, 16, 32), (2, 256, 3, 64, 32, 64),
       (1, 77, 2, 64, 128, 128), (1, 96, 2, 16, 16, 32),
       (1, 60, 3, 24, 20, 20), (1, 256, 4, 64, 128, 128)]


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-4, 1e-4)),
                                       (torch.bfloat16, (1e-5, 8e-3))])
@pytest.mark.parametrize("case", SSD)
def test_ssd_scan_kernel_matches_plain(cuda, dtype, tol, case, strided):
    *shape, chunk = case
    args = _ssd_args(shape, dtype, seed=sum(shape), strided=strided)
    before = sk.ssd_scan.launches
    y, h_last = sk.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.ssd_scan.launches == before + 1
    want_y, want_h = sk.ssd_scan_plain(*args, chunk=chunk)
    assert y.dtype == dtype and y.shape == args[0].shape
    assert h_last.dtype == torch.float32 and h_last.shape == want_h.shape
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol[0],
                               rtol=tol[1])
    torch.testing.assert_close(h_last, want_h, atol=1e-5, rtol=1e-4)
    # a single writer per element: the same call gives the same bits
    assert torch.equal(y, sk.ssd_scan(*args, chunk=chunk)[0])


def test_ssd_scan_kernel_refuses_shapes_past_its_limits(cuda):
    """The C entry checks the sizes its register tiles and shared memory
    are built for (p <= 64, n <= 128, q <= 128) and launches nothing."""
    for shape, chunk in (((1, 64, 2, 96, 16), 64), ((1, 64, 2, 32, 160), 64),
                         ((1, 256, 2, 32, 16), 256)):
        args = _ssd_args(shape, torch.float32)
        before = sk.ssd_scan.launches
        with pytest.raises(RuntimeError, match="CUDA error"):
            sk.ssd_scan(*args, chunk=chunk)
        assert sk.ssd_scan.launches == before


def test_ssd_scan_kernel_raises_when_a_gradient_is_required(cuda):
    x, *rest = _ssd_args((1, 64, 2, 32, 16), torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        sk.ssd_scan(x.requires_grad_(True), *rest, chunk=32)


def test_ssd_chunked_takes_the_plain_path_when_a_gradient_is_needed(cuda):
    args = [a.requires_grad_(True)
            for a in _ssd_args((1, 64, 2, 32, 16), torch.float32, seed=2)]
    before = sk.ssd_scan.launches
    y, h_last = ssm.ssd_chunked(*args, chunk=32)
    assert y.grad_fn is not None and sk.ssd_scan.launches == before
    grads = torch.autograd.grad((y ** 2).sum() + h_last.sum(), args)
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
    with torch.no_grad():
        y2, h2 = ssm.ssd_chunked(*args, chunk=32)
    assert sk.ssd_scan.launches == before + 1
    torch.testing.assert_close(y2, y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(h2, h_last, atol=1e-5, rtol=1e-4)


def test_ssm_engine_on_card_matches_cpu(cuda):
    """mamba2-smoke in fp32: the card's engine gives the CPU's greedy
    streams; every prefill went through the SSD kernel once a layer."""
    from repro_torch.configs import get_smoke
    cfg = get_smoke("mamba2-780m").with_(dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=3)
    params = {"cpu": cpu, "cuda": tree_map(lambda t: t.cuda(), cpu)}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,))
               for n in (64, 17, 32, 96, 9)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params[dev], slots=2, max_len=128)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=6)
        kernels.reset_launches()
        res = eng.run()
        outs[dev] = {i: list(res[i].out) for i in res}
        want = cfg.num_layers * eng.stats["prefills"] if dev == "cuda" else 0
        assert kernels.launches() == {"paged_attention": 0, "fused_mlp": 0,
                                      "flash_attention": 0, "ssd_scan": want}
    assert outs["cpu"] == outs["cuda"]
