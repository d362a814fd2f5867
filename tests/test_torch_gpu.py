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
kernel keeps them fp32, and bf16 has 8 bits of mantissa), and per value
at atol 1e-5 + rtol 8e-3 against the plain version that keeps them fp32
(the Pallas arithmetic; one bf16 ulp), at atol 1e-5 /
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
                                                (40, 8, 128, 16),
                                                (16, 16, 128, 16),
                                                (6, 6, 64, 16)])
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
    """Past the limits its shared-memory arrays are sized by, the wrapper
    refuses by ``kernel_limits`` (the C entry checks the same) and
    launches nothing."""
    rng = np.random.default_rng(0)
    args = _paged(rng, b=2, width=2, n_pages=6, page_size=page_size, hq=hq,
                  hkv=hkv, d=d, dtype=torch.float32)
    before = pa.paged_attention.launches
    with pytest.raises(ValueError, match="paged_attention kernel"):
        pa.paged_attention(*args)
    assert pa.paged_attention.launches == before


def _paged_mix(ctx, rows_slot, rows_pos, *, edit=None, seed=0):
    """Qwen3-14B heads over a 257-page pool of 16-token pages: slots
    holding ``ctx`` tokens on permuted pages, rows (slot, cursor)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, 257))
    tables = np.zeros((len(ctx), 64), np.int32)
    k = 0
    for slot, n in enumerate(ctx):
        blocks = -(-n // 16)
        tables[slot, :blocks] = perm[k:k + blocks]
        k += blocks
    if edit is not None:
        edit(tables)
    arrs = [rng.standard_normal(sh).astype(np.float32)
            for sh in ((len(rows_slot), 1, 40, 128), (257, 16, 8, 128),
                       (257, 16, 8, 128))]
    q, kp, vp = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in arrs)
    return q, kp, vp, torch.from_numpy(tables[rows_slot]).cuda(), \
        torch.tensor(rows_pos, dtype=torch.int32).cuda()


def _share_first_pages(tables):
    tables[1, :5] = tables[0, :5]


# the row structures the bf16 kernel's tiling must get right (chip_smoke.py
# phase 3): (ctx, rows' slots, rows' cursors, table edit)
PAGED_MIXES = {
    "serving mix T=256": ((716, 300, 520, 640), [0, 1, 2] + [3] * 253,
                          [715, 299, 519] + list(range(256, 509)), None),
    "tile straddling two slots": ((716, 300, 520, 640), [2] * 7 + [3] * 9,
                                  list(range(100, 107))
                                  + list(range(200, 209)), None),
    "first pages agree only": ((716, 716), [0, 1, 0, 1], [300, 400, 70, 400],
                               _share_first_pages),
    "lone 1024-token row": ((1024,), [0], [1023], None),
    "decode-only mix": ((716, 300, 520, 640), [0, 1, 2, 3] + [0] * 252,
                        [715, 299, 519, 639] + [0] * 252, None),
}


@pytest.mark.parametrize("mix", sorted(PAGED_MIXES))
def test_paged_attention_bf16_kernel_tiles_rows_correctly(cuda, mix):
    """Per value against the Pallas arithmetic (P fp32, V upcast: one bf16
    ulp, atol 1e-5 + rtol 8e-3), within 1e-2 of the gather plain version,
    the device plan equal to tile_plan, and the same bits on a second
    call."""
    ctx, rows_slot, rows_pos, edit = PAGED_MIXES[mix]
    args = _paged_mix(ctx, rows_slot, rows_pos, edit=edit)
    got = pa.paged_attention(*args)
    again = pa.paged_attention(*args)
    want = pa.paged_attention_plain_f32p(*args).float()
    torch.cuda.synchronize()
    limit = 1e-5 + 8e-3 * want.abs()
    assert ((got.float() - want).abs() <= limit).all()
    torch.testing.assert_close(got.float(),
                               pa.paged_attention_plain(*args).float(),
                               atol=1e-2, rtol=0)
    assert torch.equal(got, again)
    tab, pos = args[3], args[4]
    items, splits = pa.device_tile_plan(tab, pos, 16, 5)
    want_items, want_splits = pa.tile_plan(tab.cpu().numpy(),
                                           pos.cpu().numpy(), 16, 5)
    assert items == want_items and (splits == want_splits).all()


#: kv lengths around the 256-key segment boundary and past it, up to 16
#: segments (chip_smoke.py phase 3)
ROW_ALONE_KV = (255, 256, 257, 700, 1024, 4096)


@pytest.mark.parametrize("kv_len", ROW_ALONE_KV)
def test_paged_bf16_row_bits_depend_on_the_row_alone(cuda, kv_len):
    """Qwen3-14B heads, bf16: one row's output is the same bits alone
    (split past 256 keys), first and last in a run of its slot's 5 rows,
    and in a tile beside another slot's row that shares its pages
    (``neighbour_mixes``); alone it is within the per-value limit of the
    fp32-P plain version."""
    mixes, n_pages = pa.neighbour_mixes(kv_len)
    gen = torch.Generator(device="cuda").manual_seed(kv_len)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    kp, vp, q0 = rnd(n_pages, 16, 8, 128), rnd(n_pages, 16, 8, 128), \
        rnd(40, 128)
    outs = {}
    for name, (tab, pos, r) in mixes.items():
        q = rnd(len(pos), 1, 40, 128)
        q[r, 0] = q0
        args = (q, kp, vp, torch.from_numpy(tab).cuda(),
                torch.from_numpy(pos).cuda())
        out = pa.paged_attention(*args)
        outs[name] = out[r]
        if name == "alone":
            want = pa.paged_attention_plain_f32p(*args).float()
            assert ((out.float() - want).abs()
                    <= 1e-5 + 8e-3 * want.abs()).all()
    torch.cuda.synchronize()
    for name, out in outs.items():
        assert torch.equal(out, outs["alone"]), name


def test_device_tile_plan_equals_tile_plan_on_a_prefix_shared_mix(cuda):
    """Four slots whose tables share a 512-token prefix (32 pages), as the
    prefix cache lays them out: three decode rows and 253 rows of the
    fourth slot's chunk past the prefix, then a decode-only step (252 pad
    rows on the null page); the device plan equals ``tile_plan`` and the
    output is within the per-value limit of the fp32-P plain version."""
    rng = np.random.default_rng(8)
    perm = rng.permutation(np.arange(1, 257)).astype(np.int32)
    tables = np.zeros((4, 64), np.int32)
    tables[:, :32] = perm[:32]
    for s in range(4):
        tables[s, 32:44] = perm[32 + 12 * s:44 + 12 * s]
    mixes = [([0, 1, 2] + [3] * 253, [548, 572, 601] + list(range(512, 765))),
             ([0, 1, 2, 3] + [4] * 252, [549, 573, 602, 765] + [0] * 252)]
    tables = np.concatenate([tables, np.zeros((1, 64), np.int32)])
    for slots, cursors in mixes:
        tab = torch.from_numpy(tables[slots]).cuda()
        pos = torch.tensor(cursors, dtype=torch.int32).cuda()
        items, splits = pa.device_tile_plan(tab, pos, 16, 5)
        want_items, want_splits = pa.tile_plan(tab.cpu().numpy(),
                                               pos.cpu().numpy(), 16, 5)
        assert items == want_items and (splits == want_splits).all()
        arrs = [rng.standard_normal(sh).astype(np.float32)
                for sh in ((len(slots), 1, 40, 128), (257, 16, 8, 128),
                           (257, 16, 8, 128))]
        q, kp, vp = (torch.from_numpy(a).cuda().to(torch.bfloat16)
                     for a in arrs)
        got = pa.paged_attention(q, kp, vp, tab, pos).float()
        want = pa.paged_attention_plain_f32p(q, kp, vp, tab, pos).float()
        assert ((got - want).abs() <= 1e-5 + 8e-3 * want.abs()).all()


def test_paged_attention_bf16_check_rejects_a_dropped_live_page(cuda):
    """The per-value check above fails a run whose table drops one live
    page of the prefill slot (read by 253 rows) for the null page."""
    ctx, rows_slot, rows_pos, _ = PAGED_MIXES["serving mix T=256"]
    q, kp, vp, tab, pos = _paged_mix(ctx, rows_slot, rows_pos)
    want = pa.paged_attention_plain_f32p(q, kp, vp, tab, pos).float()
    dropped = tab.clone()
    dropped[3:, 5] = 0
    got = pa.paged_attention(q, kp, vp, dropped, pos).float()
    assert ((got - want).abs() > 1e-5 + 8e-3 * want.abs()).any()


@pytest.mark.parametrize("hq,hkv,d,page_size", [(34, 2, 16, 8),   # rep 17
                                                (8, 2, 20, 8),    # D % 8
                                                (8, 2, 136, 8),   # D > 128
                                                (8, 2, 32, 4),    # page < 8
                                                (8, 2, 32, 128),  # page > 64
                                                (8, 2, 32, 24)])  # not 2^k
def test_paged_attention_bf16_kernel_refuses_shapes_past_its_limits(
        cuda, hq, hkv, d, page_size):
    """TMA's 16-byte strides, whole swizzle atoms and whole pages a kv
    tile: past them the wrapper refuses by ``kernel_limits`` (the bf16
    entry checks the same) and launches nothing."""
    rng = np.random.default_rng(0)
    args = _paged(rng, b=2, width=2, n_pages=6, page_size=page_size, hq=hq,
                  hkv=hkv, d=d, dtype=torch.bfloat16)
    before = pa.paged_attention.launches
    with pytest.raises(ValueError, match="paged_attention kernel"):
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
    # the hybrid's shared block (Zamba2-1.2B: d 2048, f 8192, 38 layers)
    (torch.bfloat16, (1e-3, 8e-3), 77, 2048, 8192,
     (0.02, 0.02 / 76 ** 0.5)),
    # Llama-3.2-Vision-90B's decode step (4 slots; d 8192, f 28672, 100
    # layers): K 8192 is 128 stages, the down product 4 K-splits
    (torch.bfloat16, (1e-3, 8e-3), 4, 8192, 28672,
     (0.02, 0.02 / 200 ** 0.5)),
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


@pytest.mark.parametrize("mixed", [True, False])
def test_moe_engine_on_card_matches_cpu(cuda, mixed):
    """tests/test_serve_pallas.py:165 on the card: the reference's MoE
    config in fp32 on one slot with 8-token pages — the paged kernel's
    streams (card) equal the plain gather's (CPU), on the mixed step and
    on the split path; paged attention ran once a layer a program (a
    decode step on the split path), flash once a layer a split prefill,
    the fused MLP never (the experts are batched matmuls)."""
    cfg = ModelConfig(name="pal-moe", arch_type="moe", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      num_experts=4, experts_per_token=2, vocab_size=128,
                      dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=5)
    params = {"cpu": cpu, "cuda": tree_map(lambda t: t.cuda(), cpu)}
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 128, size=(n,)) for n in (5, 8, 6)]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params[dev], slots=1, max_len=32,
                          page_size=8, mixed=mixed)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=4)
        kernels.reset_launches()
        res = eng.run()
        outs[dev] = {i: list(res[i].out) for i in res}
        on = cfg.num_layers if dev == "cuda" else 0
        runs = eng.stats["mixed_steps"] if mixed \
            else eng.stats["decode_steps"]
        flash = 0 if mixed else eng.stats["prefills"]
        assert kernels.launches() == {"paged_attention": on * runs,
                                      "fused_mlp": 0,
                                      "flash_attention": on * flash,
                                      "ssd_scan": 0}
        assert eng.stats["decode_traces"] == 1
    assert outs["cpu"] == outs["cuda"]


@pytest.mark.parametrize("mixed", [True, False])
def test_encdec_engine_on_card_matches_cpu(cuda, mixed):
    """tests/test_serve_pallas.py:176 on the card: the reference's enc-dec
    config in fp32 — the paged kernel on the decoder's self-attention K/V
    (card) gives the plain gather's streams (CPU) while the per-slot cross
    K/V path is plain on both, on the mixed step and on the split path;
    paged attention ran once a layer a program (a decode step on the
    split path), flash once an encoder layer an admission (and once a
    decoder layer a split prefill), the fused MLP never (plain GeLU)."""
    cfg = ModelConfig(name="pal-encdec", arch_type="audio", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
                      vocab_size=128, encoder_layers=1, encoder_ctx=12,
                      dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=2)
    params = {"cpu": cpu, "cuda": tree_map(lambda t: t.cuda(), cpu)}
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 128, size=(n,)) for n in (4, 7, 5)]
    frames = [rng.standard_normal((12, 64)).astype(np.float32)
              for _ in prompts]
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params[dev], slots=2, max_len=32,
                          mixed=mixed)
        for i, (p, f) in enumerate(zip(prompts, frames)):
            eng.submit(i, p, max_new=5, frames=f)
        kernels.reset_launches()
        res = eng.run()
        outs[dev] = {i: list(res[i].out) for i in res}
        on = 1 if dev == "cuda" else 0
        st = eng.stats
        runs = st["mixed_steps"] if mixed else st["decode_steps"]
        flash = st["prefills"] * (cfg.encoder_layers
                                  + (0 if mixed else cfg.num_layers))
        assert kernels.launches() == {
            "paged_attention": on * cfg.num_layers * runs, "fused_mlp": 0,
            "flash_attention": on * flash, "ssd_scan": 0}
        assert st["decode_traces"] == 1
        assert st["encode_traces"] == (1 if mixed else 0)
    assert outs["cpu"] == outs["cuda"]


def test_vlm_engine_on_card_matches_cpu(cuda):
    """llama-vision-smoke in fp32 with both gates of its cross layer open
    (closed, the images would not reach the logits): the card's engine
    (split path, dense rows) gives the CPU's greedy streams; every prefill
    ran flash once a self layer, every program (prefill or decode) the
    fused MLP once a layer, self or cross, and nothing ran paged
    attention or the SSD scan."""
    from repro_torch.configs import get_smoke
    cfg = get_smoke("llama-3.2-vision-90b").with_(dtype="float32")
    g, _ = cfg.vlm_groups
    cpu = init_params(cfg, device="cpu", seed=3)
    for gate in ("gate_attn", "gate_mlp"):
        cpu["cross"][gate].fill_(1.0)
    params = {"cpu": cpu, "cuda": tree_map(lambda t: t.cuda(), cpu)}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,))
               for n in (5, 23, 9, 40, 6)]
    images = rng.standard_normal((len(prompts), cfg.num_image_tokens,
                                  cfg.d_model)).astype(np.float32)
    outs = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params[dev], slots=2, max_len=64)
        assert not eng.paged and not eng.mixed
        for i, (p, im) in enumerate(zip(prompts, images)):
            eng.submit(i, p, max_new=6, images=im)
        kernels.reset_launches()
        res = eng.run()
        outs[dev] = {i: list(res[i].out) for i in res}
        pf, dec = eng.stats["prefills"], eng.stats["decode_steps"]
        on = dev == "cuda"
        assert kernels.launches() == {
            "paged_attention": 0,
            "fused_mlp": cfg.num_layers * (pf + dec) if on else 0,
            "flash_attention": (cfg.num_layers - g) * pf if on else 0,
            "ssd_scan": 0}
    assert outs["cpu"] == outs["cuda"]


@pytest.mark.parametrize("drafter", ["ngram", "model"])
def test_spec_engine_on_card_matches_spec_off_and_cpu(cuda, drafter):
    """f32 speculative decode on the card (k 4, on repetitive prompts):
    the streams equal the card's spec-off run and the CPU's spec run, the
    drafted/accepted counters equal the CPU's, and every program ran both
    serving kernels once a layer; the model drafter (the reference's
    one-layer fp32 default) runs flash and the fused MLP once a layer a
    draft token (its weights drawn on the CPU and moved, so both devices
    draft alike)."""
    from repro_torch.serve.speculative import SpecConfig, default_draft_cfg
    cfg = ModelConfig(name="pal-dense", arch_type="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=128, dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=3)
    params = {"cpu": cpu, "cuda": tree_map(lambda t: t.cuda(), cpu)}
    dcfg = default_draft_cfg(cfg)
    dcpu = init_params(dcfg, device="cpu", seed=7)
    draft = {"cpu": dcpu, "cuda": tree_map(lambda t: t.cuda(), dcpu)}

    def make_spec(dev):
        if drafter == "ngram":
            return SpecConfig(k=4)
        return SpecConfig(k=4, drafter="model", draft_cfg=dcfg,
                          draft_params=draft[dev])

    rng = np.random.default_rng(19)
    prompts = [np.resize(rng.integers(0, 128, size=(int(rng.integers(3, 7)),)),
                         int(rng.integers(20, 41))) for _ in range(4)]
    runs = {}
    for dev, spec in (("cpu", make_spec("cpu")),
                      ("cuda", make_spec("cuda")), ("cuda", None)):
        eng = ServeEngine(cfg, params[dev], slots=2, max_len=64,
                          chunk_tokens=16, spec=spec)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=12)
        kernels.reset_launches()
        res = eng.run()
        st = eng.stats
        on = dev == "cuda"
        drafts = st["spec_drafted"] if on and drafter == "model" else 0
        assert kernels.launches() == {
            "paged_attention": 2 * st["mixed_steps"] if on else 0,
            "fused_mlp": 2 * st["mixed_steps"] + drafts if on else 0,
            "flash_attention": drafts, "ssd_scan": 0}
        runs[(dev, spec is not None)] = (
            {i: list(res[i].out) for i in res},
            (st["spec_drafted"], st["spec_accepted"], st["decode_traces"]))
    assert runs[("cuda", True)][0] == runs[("cuda", False)][0] \
        == runs[("cpu", True)][0]
    assert runs[("cuda", True)][1] == runs[("cpu", True)][1]
    assert runs[("cuda", True)][1][0] > 0
    assert runs[("cuda", True)][1][2] == runs[("cuda", False)][1][2]


@pytest.mark.parametrize("layout", [dict(mixed=False), dict(paged=False)])
def test_split_engines_on_card_match_cpu(cuda, layout):
    """The f32 split path on the card — on the pool (``mixed=False``) and
    on the dense layout (``paged=False``) — gives the CPU's first-step
    logits within 1e-4 and its greedy streams; every prefill ran the
    flash kernel once a layer, every program the fused MLP once a layer,
    and every decode paged attention once a layer on the pool only."""
    cfg = ModelConfig(name="pal-dense", arch_type="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=128, dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=3)
    params = {"cpu": cpu, "cuda": tree_map(lambda t: t.cuda(), cpu)}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, size=(n,)) for n in (5, 23, 9, 40, 6)]
    outs, first = {}, {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params[dev], slots=2, max_len=64, **layout)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=6)
        kernels.reset_launches()
        eng.step()
        first[dev] = eng.last_logits.float().cpu()
        res = eng.run()
        outs[dev] = {i: list(res[i].out) for i in res}
        pf, dec = eng.stats["prefills"], eng.stats["decode_steps"]
        on = dev == "cuda"
        assert kernels.launches() == {
            "paged_attention": 2 * dec if on and eng.paged else 0,
            "fused_mlp": 2 * (pf + dec) if on else 0,
            "flash_attention": 2 * pf if on else 0, "ssd_scan": 0}
    assert (first["cpu"] - first["cuda"]).abs().max().item() <= 1e-4
    assert outs["cpu"] == outs["cuda"]


def test_bf16_paged_engine_on_card_refuses_page_size_4(cuda):
    """ROADMAP Queue 3's fault: a bf16 paged engine on the card with a
    page size the kernel cannot take raises ValueError naming the limit
    at construction, on the mixed and the split path, and nothing was
    launched."""
    cfg = ModelConfig(name="pal-dense", arch_type="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=128, dtype="bfloat16")
    params = init_params(cfg, device="cuda", seed=0)
    kernels.reset_launches()
    for kw in (dict(page_size=4), dict(page_size=4, mixed=False)):
        with pytest.raises(ValueError, match="page sizes"):
            ServeEngine(cfg, params, **kw)
    assert sum(kernels.launches().values()) == 0
    ServeEngine(cfg, params, page_size=8)          # a size it takes


#: (dtype, page_size, Hq, Hkv, D) -> refused? The refusals are the shapes
#: of the kernels' refusal tests above; the accepted ones the serving
#: path's (Qwen3-14B: 40 / 8 heads x 128, 16-token pages) and the f32
#: parity configs'
PAGED_LIMITS = [
    (torch.float32, 4, 34, 2, 16, True), (torch.float32, 4, 6, 4, 16, True),
    (torch.float32, 4, 4, 2, 512, True), (torch.float32, 256, 4, 2, 16, True),
    (torch.bfloat16, 8, 34, 2, 16, True), (torch.bfloat16, 8, 8, 2, 20, True),
    (torch.bfloat16, 8, 8, 2, 136, True), (torch.bfloat16, 4, 8, 2, 32, True),
    (torch.bfloat16, 128, 8, 2, 32, True),
    (torch.bfloat16, 24, 8, 2, 32, True), (torch.float16, 16, 8, 2, 32, True),
    (torch.bfloat16, 16, 40, 8, 128, False),
    (torch.bfloat16, 64, 32, 2, 64, False), ("bfloat16", 8, 8, 8, 8, False),
    (torch.float32, 4, 4, 2, 32, False), ("float32", 128, 8, 2, 256, False)]
FLASH_LIMITS = [(torch.bfloat16, 8, 2, 20, True),
                (torch.bfloat16, 8, 2, 136, True),
                (torch.float32, 2, 2, 256, True),
                (torch.float32, 6, 4, 32, True),
                (torch.bfloat16, 40, 8, 128, False),
                ("bfloat16", 4, 2, 8, False), (torch.float32, 4, 2, 20, False)]
#: (dtype, d, f) -> refused? The serving path's widths (Qwen3-14B) and
#: the f32 ragged shape are taken
MLP_LIMITS = [(torch.bfloat16, 64, 100, True), (torch.bfloat16, 4, 64, True),
              (torch.bfloat16, 68, 64, True), (torch.float16, 64, 64, True),
              (torch.bfloat16, 5120, 17408, False), ("bfloat16", 8, 8, False),
              (torch.float32, 72, 100, False)]
#: (dtype, h, p, n, rows a chunk) -> refused? The refusals are those of
#: ``test_ssd_scan_kernel_refuses_shapes_past_its_limits``; Mamba2-780M's
#: heads (48 x 64, n 128), the hybrid's (64 x 64, n 64) and a ragged f32
#: shape are taken
SSD_LIMITS = [(torch.float32, 2, 96, 16, 64, True),
              (torch.float32, 2, 32, 160, 64, True),
              (torch.float32, 2, 32, 16, 256, True),
              (torch.bfloat16, 2, 65, 16, 64, True),
              (torch.float16, 2, 32, 16, 64, True),
              (torch.bfloat16, 48, 64, 128, 128, False),
              (torch.bfloat16, 64, 64, 64, 128, False),
              ("bfloat16", 1, 1, 1, 1, False),
              (torch.float32, 3, 24, 20, 20, False)]


def test_kernel_limits_tables():
    """On the CPU: ``kernel_limits`` refuses the shapes of the tables
    above, with a reason naming the limit, and takes the serving path's
    shapes. The ``*_table_matches_the_c_entries`` tests below send every
    row to the C entries on the card."""
    for dtype, page, hq, hkv, d, refused in PAGED_LIMITS:
        why = pa.kernel_limits(dtype, page, hq, hkv, d)
        assert (why is not None) == refused, (dtype, page, hq, hkv, d, why)
    for dtype, hq, hkv, d, refused in FLASH_LIMITS:
        why = fa.kernel_limits(dtype, hq, hkv, d)
        assert (why is not None) == refused, (dtype, hq, hkv, d, why)
    for dtype, d, f, refused in MLP_LIMITS:
        why = fm.kernel_limits(dtype, d, f)
        assert (why is not None) == refused, (dtype, d, f, why)
    for dtype, h, p, n, q, refused in SSD_LIMITS:
        why = sk.kernel_limits(dtype, h, p, n, q)
        assert (why is not None) == refused, (dtype, h, p, n, q, why)
    assert "state sizes" in sk.kernel_limits(torch.float32, 2, 32, 160, 64)
    assert "multiples of 8" in fm.kernel_limits(torch.bfloat16, 64, 100)
    assert "16" in pa.kernel_limits(torch.bfloat16, 8, 34, 2, 16)
    assert "(8, 16, 32, 64)" in pa.kernel_limits(torch.bfloat16, 4, 8, 2,
                                                 32)
    assert "multiples of 8" in fa.kernel_limits(torch.bfloat16, 8, 2, 20)


def _dt(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _with_entry(table):
    """The rows of a limits table whose dtype has a C entry."""
    return [r for r in table if _dt(r[0]) in (torch.float32, torch.bfloat16)]


@pytest.mark.parametrize("dtype,page,hq,hkv,d,refused",
                         _with_entry(PAGED_LIMITS))
def test_paged_limits_table_matches_the_c_entries(cuda, dtype, page, hq, hkv,
                                                  d, refused):
    """Each row of ``PAGED_LIMITS`` sent to the C entry itself, past the
    wrapper's check: it refuses (a nonzero code, nothing written) exactly
    the rows ``kernel_limits`` refuses, and the output of a row it takes
    agrees with the plain version (bf16 per value with P fp32)."""
    dtype = _dt(dtype)
    args = _paged(np.random.default_rng(0), b=2, width=2, n_pages=6,
                  page_size=page, hq=hq, hkv=hkv, d=d, dtype=dtype)
    out = torch.zeros_like(args[0])
    code = pa.launch_entry(*args, out)
    torch.cuda.synchronize()
    assert (code != 0) == refused, code
    if refused:
        assert not out.any()
    elif dtype == torch.float32:
        torch.testing.assert_close(out, pa.paged_attention_plain(*args),
                                   atol=2e-5, rtol=2e-5)
    else:
        torch.testing.assert_close(
            out.float(), pa.paged_attention_plain_f32p(*args).float(),
            atol=1e-5, rtol=8e-3)


@pytest.mark.parametrize("dtype,hq,hkv,d,refused", _with_entry(FLASH_LIMITS))
def test_flash_limits_table_matches_the_c_entries(cuda, dtype, hq, hkv, d,
                                                  refused):
    """As above for ``FLASH_LIMITS`` (causal, 64 positions)."""
    dtype = _dt(dtype)
    q, k, v, kw = _flash_args((1, 64, 64, hq, hkv, d, True, 0), dtype)
    out = torch.zeros_like(q)
    code = fa.launch_entry(q, k, v, out, **kw)
    torch.cuda.synchronize()
    assert (code != 0) == refused, code
    if refused:
        assert not out.any()
    else:
        tol = (2e-6, 2e-6) if dtype == torch.float32 else (1e-5, 8e-3)
        torch.testing.assert_close(
            out.float(), fa.flash_attention_plain(q, k, v, **kw).float(),
            atol=tol[0], rtol=tol[1])


@pytest.mark.parametrize("dtype,d,f,refused", _with_entry(MLP_LIMITS))
def test_mlp_limits_table_matches_the_c_entries(cuda, dtype, d, f, refused):
    """As above for ``MLP_LIMITS`` (16 rows, the weights at the model's
    init scales as in ``test_fused_mlp_kernel_matches_plain``)."""
    dtype = _dt(dtype)
    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn((16, d), generator=gen, device="cuda").to(dtype)
    ws = [(torch.randn(s, generator=gen, device="cuda") * sc).to(dtype)
          for s, sc in (((d, f), 0.02), ((d, f), 0.02),
                        ((f, d), 0.02 / 80 ** 0.5))]
    out = torch.zeros_like(x)
    code = fm.launch_entry(x, *ws, out)
    torch.cuda.synchronize()
    assert (code != 0) == refused, code
    if refused:
        assert not out.any()
    else:
        tol = (1e-5, 1e-5) if dtype == torch.float32 else (1e-3, 8e-3)
        torch.testing.assert_close(out.float(),
                                   fm.fused_mlp_plain(x, *ws).float(),
                                   atol=tol[0], rtol=tol[1])


@pytest.mark.parametrize("dtype,h,p,n,q,refused", _with_entry(SSD_LIMITS))
def test_ssd_limits_table_matches_the_c_entry(cuda, dtype, h, p, n, q,
                                              refused):
    """As above for ``SSD_LIMITS`` (two chunks of q rows, one when q is a
    single row; x, B and C views of one buffer): the C entry refuses
    exactly the rows ``kernel_limits`` refuses, and the output of a row it
    takes agrees with the plain version (y and the final state)."""
    dtype = _dt(dtype)
    s = 2 * q if q > 1 else 1
    args = _ssd_args((1, s, h, p, n), dtype, seed=h + p + n, strided=True)
    y = torch.zeros((1, s, h, p), dtype=dtype, device="cuda")
    h_last = torch.zeros((1, h, p, n), dtype=torch.float32, device="cuda")
    code = sk.launch_entry(*args, y, h_last, q=q)
    torch.cuda.synchronize()
    assert (code != 0) == refused, code
    if refused:
        assert not y.any() and not h_last.any()
    else:
        want_y, want_h = sk.ssd_scan_plain(*args, chunk=q)
        tol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-5, 8e-3)
        torch.testing.assert_close(y.float(), want_y.float(), atol=tol[0],
                                   rtol=tol[1])
        torch.testing.assert_close(h_last, want_h, atol=1e-5, rtol=1e-4)


def test_trainer_on_cuda_refuses_flash_limits_at_construction():
    """On the CPU: training a config whose heads the flash kernel cannot
    take, on a CUDA device, raises ValueError at ``Trainer`` (and so
    ``Session.train``) construction, before any parameter is made."""
    from repro_torch.api import Session
    from repro_torch.train.trainer import TrainConfig, Trainer
    cfg = ModelConfig(name="odd-heads", arch_type="dense", num_layers=1,
                      d_model=80, num_heads=4, num_kv_heads=2, d_ff=64,
                      vocab_size=64, dtype="bfloat16")   # D = 20
    with pytest.raises(ValueError, match="flash-attention kernel"):
        Trainer(cfg, Strategy(), "cuda", TrainConfig())
    with pytest.raises(ValueError, match="multiples of 8"):
        Session(cfg, device="cuda").train(global_batch=1, seq_len=16)


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


# bf16 only: Kimi's head width (112) with causal GQA, the training
# shape's heads (40/8 x 128) at S = T = 1024, the hybrid's shared block
# (32/32 x 64: GQA rep 1, D 64), whisper-tiny's encoder (6/6 x 64,
# non-causal over 1500 frames: 11 key tiles of 128 and a ragged tail of
# 92) and Llama-3.2-Vision-90B's self layers (64/8 x 128: GQA rep 8)
FLASH_BF16 = [(1, 300, 300, 8, 2, 112, True, 0),
              (1, 1024, 1024, 40, 8, 128, True, 0),
              (1, 300, 300, 32, 32, 64, True, 0),
              (1, 1500, 1500, 6, 6, 64, False, 0),
              (1, 512, 512, 64, 8, 128, True, 0)]


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
    is at most 128: the wrapper refuses by ``kernel_limits`` (the bf16
    entry checks the same) and launches nothing otherwise."""
    q, k, v, kw = _flash_args((1, 64, 64, 2, 2, d, True, 0), torch.bfloat16)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="flash_attention kernel"):
        fa.flash_attention(q, k, v, **kw)
    assert fa.flash_attention.launches == before


def test_fused_mlp_bf16_kernel_refuses_f_not_a_multiple_of_8(cuda):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((16, 64), generator=gen, device="cuda").to(torch.bfloat16)
    ws = [torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
          for s in ((64, 100), (64, 100), (100, 64))]
    before = fm.fused_mlp.launches
    with pytest.raises(ValueError, match="fused_mlp kernel"):
        fm.fused_mlp(x, *ws)
    assert fm.fused_mlp.launches == before


def test_flash_attention_kernel_refuses_head_dim_past_its_limit(cuda):
    q, k, v, kw = _flash_args((1, 64, 64, 2, 2, 256, True, 0),
                              torch.float32)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="flash_attention kernel"):
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
# several chunks, a ragged p and n, the serving path's head, and the
# hybrid's heads (64 x p 64 = MAX_P, n 64)
SSD = [(2, 128, 2, 32, 16, 32), (2, 256, 3, 64, 32, 64),
       (1, 77, 2, 64, 128, 128), (1, 96, 2, 16, 16, 32),
       (1, 60, 3, 24, 20, 20), (1, 256, 4, 64, 128, 128),
       (2, 1024, 4, 64, 128, 128),
       (1, 256, 64, 64, 64, 128)]             # the hybrid's Mamba layer


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
    assert (h_last - want_h).abs().max() <= 1e-4 * want_h.abs().max()
    # a single writer per element: the same call gives the same bits
    assert torch.equal(y, sk.ssd_scan(*args, chunk=chunk)[0])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-4, 1e-4)),
                                       (torch.bfloat16, (1e-5, 8e-3))])
def test_ssd_scan_kernel_matches_plain_on_unaligned_views(cuda, dtype, tol):
    """x, B and C one element off a 4-element boundary: the kernel stages
    them element by element instead of in groups of 4."""
    b, s, h, p, n = 1, 256, 4, 64, 128
    gen = torch.Generator(device="cuda").manual_seed(5)
    buf = (torch.randn((b, s, 1 + h * p + 2 * n), generator=gen,
                       device="cuda") * 0.4).to(dtype)
    x = buf[..., 1:1 + h * p].reshape(b, s, h, p)
    B, C = buf[..., 1 + h * p:1 + h * p + n], buf[..., 1 + h * p + n:]
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen,
                                                  device="cuda"))
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda"))
    y, h_last = sk.ssd_scan(x, dt, A, B, C, chunk=128)
    want_y, want_h = sk.ssd_scan_plain(x, dt, A, B, C, chunk=128)
    torch.testing.assert_close(y.float(), want_y.float(), atol=tol[0],
                               rtol=tol[1])
    torch.testing.assert_close(h_last, want_h, atol=1e-5, rtol=1e-4)


def test_ssd_scan_kernel_refuses_shapes_past_its_limits(cuda):
    """The sizes its register tiles and shared memory are built for (p <=
    64, n <= 128, q <= 128): the wrapper refuses past them by
    ``kernel_limits`` (the C entry checks the same:
    ``test_ssd_limits_table_matches_the_c_entry``) and launches
    nothing."""
    for shape, chunk in (((1, 64, 2, 96, 16), 64), ((1, 64, 2, 32, 160), 64),
                         ((1, 256, 2, 32, 16), 256)):
        args = _ssd_args(shape, torch.float32)
        before = sk.ssd_scan.launches
        with pytest.raises(ValueError, match="ssd_scan kernel"):
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


def test_hybrid_engine_on_card_matches_cpu(cuda):
    """zamba2-smoke in fp32: the card's engine gives the CPU's greedy
    streams; every prefill ran the SSD kernel once a Mamba layer and flash
    once a group, every program (prefill or decode) the fused MLP once a
    group, and nothing ran paged attention."""
    from repro_torch.configs import get_smoke
    cfg = get_smoke("zamba2-1.2b").with_(dtype="float32")
    g = cfg.num_layers // cfg.hybrid_attn_every
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
        pf, dec = eng.stats["prefills"], eng.stats["decode_steps"]
        on = dev == "cuda"
        assert kernels.launches() == {
            "paged_attention": 0, "fused_mlp": g * (pf + dec) if on else 0,
            "flash_attention": g * pf if on else 0,
            "ssd_scan": cfg.num_layers * pf if on else 0}
    assert outs["cpu"] == outs["cuda"]


def test_ssm_train_step_on_card_matches_cpu(cuda):
    """One fp32 AdamW step on mamba2-smoke (remat on): loss, grad norm and
    params within 1e-4 of the CPU's; training takes the plain SSD scan
    (no backward in the kernel), so no kernel runs."""
    from repro_torch.configs import get_smoke
    cfg = get_smoke("mamba2-780m").with_(dtype="float32")
    strat = Strategy(dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=3)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 64)).astype(np.int32))
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev, copy=True), cpu)
        opt = step.init_opt_state(params, strat)
        kernels.reset_launches()
        params, opt, m = step.make_train_step(cfg, strat, lr=1e-5)(
            params, opt, {"tokens": tokens.to(dev)})
        assert sum(kernels.launches().values()) == 0
        out[dev] = ({k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in flatten(params).items()})
    for key in ("loss", "grad_norm"):
        assert out["cuda"][0][key] == pytest.approx(out["cpu"][0][key],
                                                    abs=1e-4)
    for key, p in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][key], p, atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("b,hq,d,n_blocks,page_size", [
    (256, 40, 128, 64, 16), (4, 40, 128, 64, 16), (4, 40, 128, 256, 16),
    (8, 6, 64, 28, 16), (3, 16, 128, 7, 8), (1, 64, 128, 300, 64)])
def test_paged_scratch_mirror_equals_the_c_entry(cuda, b, hq, d, n_blocks,
                                                 page_size):
    """The Python size of the bf16 entry's plan and partials (which the
    wrapper allocates, on the card and on meta) is the C entry's."""
    lib = kernels.build.load("paged_attention")
    assert pa.scratch_bytes(b, hq, d, n_blocks, page_size) == \
        pa.c_scratch_bytes(lib, b, hq, d, n_blocks, page_size)


@pytest.mark.parametrize("shape", [(1, 1024, 48, 64, 128, 128),
                                   (1, 77, 64, 64, 64, 77),
                                   (2, 96, 4, 16, 8, 32),
                                   (4, 512, 64, 64, 64, 128)])
def test_ssd_scratch_mirror_equals_the_c_entry(cuda, shape):
    lib = kernels.build.load("ssd_scan")
    assert sk.scratch_words(*shape) == sk.c_scratch_words(lib, *shape)


def test_meta_branch_charges_what_the_card_charges(cuda):
    """Each wrapper on meta as the card's branch charges the cost, scratch
    and launch the card's call charges, and allocates alike."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.roofline import Counter
    gen = torch.Generator(device="cuda").manual_seed(36)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    xs = [rnd(1, 256, 8, 64), rnd(1, 256, 2, 64), rnd(64, 128),
          rnd(128, 256), rnd(128, 256), rnd(256, 128), rnd(1, 128, 4, 16),
          rnd(1, 128, 4, dtype=torch.float32).abs(),
          -rnd(4, dtype=torch.float32).abs(), rnd(1, 128, 8),
          rnd(1, 128, 8)]

    def calls(q, k, x, wg, wu, wd, xs_, dt, a, bm, cm):
        fa.flash_attention(q, k, k)
        with torch.no_grad():
            fm.fused_mlp(x, wg, wu, wd)
            sk.ssd_scan(xs_, dt, a, bm, cm, chunk=64)

    metas = [x.to("meta") for x in xs]
    with Counter() as card:
        calls(*xs)
    with Counter() as meta, dispatch.as_device("cuda"):
        calls(*metas)
    assert meta.kernels == card.kernels and card.kernels
    assert meta.flops == card.flops and meta.bytes == card.bytes
