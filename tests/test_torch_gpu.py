"""The port's CUDA kernels and engine on the card (``gpu`` marker).

On a machine with an NVIDIA GPU and ``nvcc``:

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because the suite's conftest imports jax, which the
card's machine need not have: this file imports only torch, numpy and the
port.) Without a card every test skips inside its fixture, so every
pytest worker collects the same tests.

Tolerances: fp32 kernels against their plain versions at 2e-5 (paged
attention, another summation order and ``expf``) and 1e-5 (fused MLP);
bf16 at 2e-2 (the kernel keeps the softmax probs in fp32 where the plain
version rounds them to bf16, and bf16 has 8 bits of mantissa).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.kernels import fused_mlp as fm  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

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


@pytest.mark.parametrize("dtype,tol,t,d,f", [
    (torch.float32, 1e-5, 37, 72, 100),      # ragged T, d, f
    (torch.float32, 1e-5, 128, 64, 256),
    (torch.bfloat16, 2e-2, 70, 256, 520),    # ragged T and f tiles
])
def test_fused_mlp_kernel_matches_plain(cuda, dtype, tol, t, d, f):
    gen = torch.Generator(device="cuda").manual_seed(t)
    x = torch.randn((t, d), generator=gen, device="cuda").to(dtype)
    ws = [(torch.randn(s, generator=gen, device="cuda") * 0.05).to(dtype)
          for s in ((d, f), (d, f), (f, d))]
    before = fm.fused_mlp.launches
    got = fm.fused_mlp(x, *ws)
    assert fm.fused_mlp.launches == before + 1
    torch.testing.assert_close(got.float(),
                               fm.fused_mlp_plain(x, *ws).float(),
                               atol=tol, rtol=tol)
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
                                      "fused_mlp": want}
        assert eng.stats["decode_backend"] == \
            ("kernel" if dev == "cuda" else "plain")
    assert outs["cpu"] == outs["cuda"]
