#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero; no result line is printed then):

1. the card: ``torch.cuda.is_available()`` or exit 1; name and power
   limit from ``nvidia-smi``;
2. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, started together) and print ptxas's register / shared-memory
   / spill lines, and the HGMMA (wgmma) and UTMALDG (TMA load) counts in
   the SASS of the tensor-core kernels (``cuobjdump -sass``; each must
   be > 0 where the toolkit has cuobjdump);
3. hold each kernel against its plain PyTorch version on the card at the
   shapes of its path (bf16) and at small fp32 shapes, with the
   tolerance stated beside each (flash attention also on ragged,
   windowed and non-causal inputs, and its gradients; the bf16 flash and
   fused-MLP checks are per value, and each is shown to reject a
   defective plain variant); the SSD scan in
   bf16 at the SSM prefill's shape (b 1, s 1024, h 48, p 64, n 128,
   chunk 128; x, B, C read in place as views of one conv-output buffer)
   with y within atol 1e-5 + rtol 8e-3 of each value and the final state
   within 1e-4 of its largest value (and the check shown to reject a
   scan that drops the carried state), and in fp32 at small shapes with
   a ragged chunk (s 77 at chunk 128) and several chunks (s 96 at chunk
   32) within 1e-4; time kernel, plain version and one PyTorch library
   call computing the same function (never called by the port; none
   exists for the SSD scan) with CUDA events, and compute each kernel's
   bound from these inputs and NVIDIA's H100 SXM data sheet;
4. tiny float32 configs on the card and on the CPU (TF32 off): through
   the port's engine, first-step logits within 1e-4 and greedy streams
   identical; through the split-path engine on ``mamba2-smoke``,
   first-prefill logits within 1e-4 and greedy streams identical, the
   SSD kernel launched layers x prefills times on the card; through the
   train step, loss and gradients within 1e-4;
5. the SERVING PATH: ``Session(get_config("qwen3-14b"), device="cuda")
   .serve(slots=4, max_len=1024, page_size=16, chunk_tokens=256)`` at full
   width with random weights from ``--seed``, 6 requests of 24-700 prompt
   tokens and 16 new tokens each. Launch counts are zeroed just before and
   read just after: paged attention and the fused MLP must each have run
   ``layers x program runs`` times. Prints tokens/s, step p50 and peak
   memory; then one more pair of requests runs under ``torch.profiler``
   for the device-time breakdown;
6. the TRAIN PATH: the serving session is freed, then
   ``Session(qwen3-14b with num_layers=4, device="cuda").train(
   TrainConfig(steps=6, lr=3e-4), global_batch=1, seq_len=4096)`` with
   the default Strategy (AdamW, remat on, ``attn_impl="auto"``) at full
   width; depth is the one cut. Counts are zeroed just before and read
   just after: flash attention must have run ``layers x steps x 2``
   times (each layer's forward and its remat recompute), the fused MLP
   never (training takes the plain SwiGLU). Every loss and grad norm
   must be finite and the peak memory under the card's. Prints step p50,
   tokens/s, peak memory and the model-FLOPs share of 989 TFLOP/s;
7. the SSM SERVING PATH, after the trainer is freed:
   ``Session(get_config("mamba2-780m"), device="cuda").serve(slots=4,
   max_len=2048)`` at full width (48 layers, bf16, random weights from
   ``--seed``) through the split path: 6 requests of 1024, 640, 384,
   256, 128 and 77 prompt tokens (each <= 128 or a multiple of 128, the
   reference's chunk precondition), 32 new tokens each. Launch counts are
   zeroed just before and read just after: ``ssd_scan`` must have run
   exactly ``48 x prefills`` times and the three other kernels never;
   every request must finish with 32 tokens, ``prefill_traces`` equal
   the 6 distinct lengths and ``decode_traces`` 1. Prints tokens/s, step
   p50 (steps with a prefill and decode-only steps), peak memory; then
   one more pair of requests (512 and 77 tokens, 12 new each) runs under
   ``torch.profiler``, its admission step and its decode-only steps in
   two windows, for the device time by kernel group, the device ops a
   step and the idle share of each kind of step.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The full record also goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: HBM rate and dense peaks by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


# ---------------------------------------------------------------- phase 1-2

def phase_card():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    return smi


#: the tensor-core kernels: library -> substring of the kernel's symbol
TENSOR_CORE_KERNELS = {"flash_attention": "flash_fwd_wgmma_kernel",
                       "fused_mlp": "mlp_tma_wgmma_kernel"}


def sass_counts(build):
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in the SASS of
    each tensor-core kernel, by ``cuobjdump -sass`` (beside the ``nvcc``
    that built it) on its library; None where the toolkit has none."""
    exe = Path(build._nvcc()).with_name("cuobjdump")
    if not exe.exists():
        return None
    counts = {}
    for lib, symbol in TENSOR_CORE_KERNELS.items():
        text = subprocess.run([str(exe), "-sass", str(build._target(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for section in text.split("Function : ")[1:]:
            name = section.split(None, 1)[0]
            if symbol in name:
                counts[name] = {op: section.count(op)
                                for op in ("HGMMA", "UTMALDG")}
    return counts


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    dt = time.perf_counter() - t0
    log(f"[build] {len(build.SIGNATURES)} kernels "
        f"({', '.join(build.SIGNATURES)}) built and loaded in {dt:.1f}s")
    for name, text in build.PTXAS_LOG.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                log(f"[ptxas {name}] {line.strip()}")
    sass = sass_counts(build)
    if sass is None:
        log("[sass] cuobjdump not found: HGMMA / UTMALDG not counted")
    else:
        for symbol in TENSOR_CORE_KERNELS.values():
            check(any(symbol in n for n in sass),
                  f"no {symbol} in the SASS of its library")
        for name, c in sass.items():
            log(f"[sass] {name[:70]}: {c['HGMMA']} HGMMA, {c['UTMALDG']} "
                f"UTMALDG")
            check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
                  f"{name}: no wgmma or no TMA load in its SASS ({c})")
    return dt, sass


# ------------------------------------------------------------------ phase 3

def attention_inputs(rng, dtype, *, n_layers_copies=1):
    """The main path's paged-attention shapes (Qwen3-14B heads, T = 256
    rows of a mixed step over a 4-slot x 1024-token pool of 16-token
    pages): three decode rows at their slots' cursors and 253 rows of one
    slot's prefill chunk, on permuted, fragmented page tables."""
    hq, hkv, d, ps, width, n_pages = 40, 8, 128, 16, 64, 257
    ctx = [716, 300, 520, 640]                # tokens held per slot
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((4, width), np.int32)
    k = 0
    for s, n in enumerate(ctx):
        blocks = -(-n // ps)
        tables[s, :blocks] = perm[k:k + blocks]
        k += blocks
    rows_slot = [0, 1, 2] + [3] * 253
    rows_pos = [ctx[0] - 1, ctx[1] - 1, ctx[2] - 1] + list(range(256, 509))
    tab = torch.from_numpy(tables[rows_slot]).cuda()
    pos = torch.tensor(rows_pos, dtype=torch.int32).cuda()
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    pools = [(torch.randn((n_pages, ps, hkv, d), generator=gen,
                          device="cuda").to(dtype),
              torch.randn((n_pages, ps, hkv, d), generator=gen,
                          device="cuda").to(dtype))
             for _ in range(n_layers_copies)]
    q = torch.randn((256, 1, hq, d), generator=gen, device="cuda").to(dtype)
    # live tokens per slot: the longest cursor of any row of that slot
    live = {}
    for s, p in zip(rows_slot, rows_pos):
        live[s] = max(live.get(s, 0), p + 1)
    return q, pools, tab, pos, sum(live.values()), tables, rows_slot, live


def phase_attention(rng):
    from repro_torch.kernels import paged_attention as pa
    res = {}
    # bf16: the two round differently (the plain version casts the probs to
    # bf16 before P.V, the kernel keeps them fp32); 1e-2 is 2.5 bf16 ulps at
    # |out| in [0.5, 1). fp32 carries the check on the kernel's logic.
    tol = {"bfloat16": (1e-2, 0.0), "float32": (2e-5, 2e-5)}
    for dt_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dt_name)
        q, pools, tab, pos, live_tokens, tables, rows_slot, live = \
            attention_inputs(rng, dtype)
        kp, vp = pools[0]
        got = pa.paged_attention(q, kp, vp, tab, pos)
        want = pa.paged_attention_plain(q, kp, vp, tab, pos)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(bool(torch.isfinite(got).all()), "attention output finite")
        atol, rtol = tol[dt_name]
        check(torch.allclose(got.float(), want.float(), atol=atol,
                              rtol=rtol),
              f"paged attention {dt_name} kernel vs plain: max abs err "
              f"{err} > atol {atol}, rtol {rtol}")
        ref = want.float()
        log(f"[attention {dt_name}] kernel vs plain max_abs_err {err:.3e} "
            f"(atol {atol}, rtol {rtol}; reference rms "
            f"{ref.pow(2).mean().sqrt().item():.3e}, max "
            f"{ref.abs().max().item():.3e})")
        res[dt_name] = err
    # null-page / tail poisoning (tests/test_serve_pallas.py:105): pages no
    # row references, page 0, and every slot's positions past its longest
    # cursor hold 1e9 — the kernel output must not change, bit for bit
    q, pools, tab, pos, _, tables, rows_slot, live = \
        attention_inputs(rng, torch.bfloat16)
    kp, vp = pools[0]
    clean = pa.paged_attention(q, kp, vp, tab, pos)
    used = set()
    for s, n in live.items():
        blocks = -(-n // 16)
        used.update(int(x) for x in tables[s, :blocks])
        last = int(tables[s, blocks - 1])
        kp[last, n - (blocks - 1) * 16:] = 1e9
        vp[last, n - (blocks - 1) * 16:] = 1e9
    poison = [p for p in range(kp.shape[0]) if p not in used]
    kp[poison] = 1e9
    vp[poison] = 1e9
    dirty = pa.paged_attention(q, kp, vp, tab, pos)
    check(torch.equal(clean, dirty), "poisoned null/unreferenced/tail "
          "pages changed the kernel output")
    log(f"[attention] poisoning {len(poison)} unreferenced pages and "
        f"{len(live)} slot tails: output bitwise unchanged")
    # times at the main path's bf16 shapes; 8 layer pools in rotation so
    # the pool (16.8 MB a layer) is not warm in the 50 MB L2
    q, pools, tab, pos, live_tokens, *_ = attention_inputs(
        rng, torch.bfloat16, n_layers_copies=8)
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % len(pools)
        return pools[it["i"]]

    kernel = time_ms(lambda: pa.paged_attention(q, *nxt(), tab, pos))
    plain = time_ms(lambda: pa.paged_attention_plain(
        q, *nxt(), tab, pos), iters=3, warmup=1)
    # library yardstick: SDPA over the gathered, GQA-expanded KV with the
    # kv_len mask; the gather is done before the timed call
    from repro_torch.models.kvcache import gather_pages
    kp, vp = pools[0]
    rep = 40 // 8
    kg = gather_pages(kp, tab).transpose(1, 2).repeat_interleave(rep, 1)
    vg = gather_pages(vp, tab).transpose(1, 2).repeat_interleave(rep, 1)
    mask = (torch.arange(kg.shape[2], device="cuda")[None, :]
            < (pos.long() + 1)[:, None])[:, None, None, :]
    qs = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = time_ms(lambda: sdpa(qs, kg, vg, attn_mask=mask))
    del kg, vg
    d, hkv, hq, esize = 128, 8, 40, 2
    nbytes = (live_tokens * hkv * d * 2 * esize       # unique live K and V
              + 2 * q.numel() * esize                 # q in, out
              + tab.numel() * 4 + pos.numel() * 4)
    flops = 4.0 * hq * d * float((pos.long() + 1).sum().item())
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    log(f"[attention bf16 T=256] kernel {kernel:.4f} ms, plain {plain:.4f} "
        f"ms, sdpa {library:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:99",
            "max_abs_err": res["bfloat16"], "max_abs_err_f32": res["float32"],
            "tolerance": "bf16 atol 1e-2 rtol 0, fp32 atol=rtol=2e-5",
            "ms": kernel, "kernel_ms": kernel, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": library,
            "library": "scaled_dot_product_attention over gathered KV"}


def phase_mlp(rng):
    from repro_torch.kernels import fused_mlp as fm
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    # fp32 at a ragged small shape (T, d, f not multiples of any tile)
    t, d, f = 37, 72, 100
    x = torch.randn((t, d), generator=gen, device="cuda")
    w = [torch.randn(s, generator=gen, device="cuda") * 0.05
         for s in ((d, f), (d, f), (f, d))]
    err32 = (fm.fused_mlp(x, *w) - fm.fused_mlp_plain(x, *w)).abs().max()
    err32 = err32.item()
    check(err32 <= 1e-5, f"fused MLP fp32 ragged: max abs err {err32} > 1e-5")
    log(f"[mlp f32 T={t} d={d} f={f}] kernel vs plain max_abs_err "
        f"{err32:.3e} (atol 1e-5)")
    # bf16 at the main path's shape, weights at the init scales. The limit
    # is per value, atol + rtol |want|: rtol 8e-3 is one bf16 ulp of the
    # output (both round it once); atol 1e-3 covers h's rounding flips.
    # Kernel and plain version sum x.Wg and x.Wu in other orders, so ~0.5%
    # of the h values (up to |h| ~ 16, ulp 0.0625) round to the other
    # neighbour, each moving an output by ulp(h) |Wd| ~ 1e-4. The run
    # prints the atol the kernel needs and the atol a version with an
    # exactly rounded h (from fp64 sums) needs: the second is over 1e-4,
    # so 1e-4 would fail even an exact kernel. The same check rejects the
    # two plain variants below.
    t, d, f = 256, 5120, 17408
    atol, rtol = 1e-3, 8e-3
    bf = torch.bfloat16
    x = torch.randn((t, d), generator=gen, device="cuda").to(bf)
    wg = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wu = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wd = (torch.randn((f, d), generator=gen, device="cuda")
          * (0.02 / math.sqrt(80))).to(bf)
    got = fm.fused_mlp(x, wg, wu, wd).float()
    want = fm.fused_mlp_plain(x, wg, wu, wd).float()

    def excess(a):                    # worst |a - want| / (atol + rtol|want|)
        return ((a.float() - want).abs()
                / (atol + rtol * want.abs())).max().item()

    err, bf16_excess = (got - want).abs().max().item(), excess(got)
    check(bool(torch.isfinite(got).all()), "fused MLP output finite")
    check(bf16_excess <= 1.0, f"fused MLP bf16: max abs err {err}, worst "
          f"error {bf16_excess:.3f}x atol {atol} + rtol {rtol}")
    # (1) one 64-wide f tile of h dropped (its rows of Wd zeroed)
    wd_drop = wd.clone()
    wd_drop[f // 2:f // 2 + 64] = 0
    drop = excess(fm.fused_mlp_plain(x, wg, wu, wd_drop))
    # (2) the down projection split in K as the kernel splits it, each
    # partial rounded to bf16 before the sum
    plan = fm.mlp_plan(t, d, f, torch.cuda.get_device_properties(
        0).multi_processor_count)
    splits = plan[0]
    x32 = x.float()
    h = (torch.nn.functional.silu(x32 @ wg.float())
         * (x32 @ wu.float())).to(bf).float()
    cuts = [f * i // max(splits, 2) for i in range(max(splits, 2) + 1)]
    rounded = sum((h[:, a:b] @ wd[a:b].float()).to(bf).float()
                  for a, b in zip(cuts[:-1], cuts[1:]))
    partials_bf16 = excess(rounded.to(bf))
    del h, rounded, wd_drop

    def atol_needed(a):
        return ((a.float() - want).abs() - rtol * want.abs()).max().item()

    x64 = x.double()
    h = (torch.nn.functional.silu(x64 @ wg.double())
         * (x64 @ wu.double())).to(bf)
    need = {"kernel": atol_needed(got),
            "exact_h": atol_needed((h.double() @ wd.double()).to(bf))}
    del x64, h
    check(drop > 1.0 and partials_bf16 > 1.0,
          f"the bf16 check passes a defective version (dropped f tile "
          f"{drop:.3f}x, bf16 partials {partials_bf16:.3f}x the limit)")
    log(f"[mlp bf16 T={t} d={d} f={f}] kernel vs plain max_abs_err "
        f"{err:.3e}, worst error {bf16_excess:.3f}x the limit (atol {atol}, "
        f"rtol {rtol}; reference rms {want.pow(2).mean().sqrt().item():.3e},"
        f" max {want.abs().max().item():.3e}); a dropped 64-wide f tile "
        f"would be {drop:.1f}x, bf16 down partials ({max(splits, 2)} "
        f"splits) {partials_bf16:.2f}x the limit; atol needed at rtol "
        f"{rtol}: the kernel {need['kernel']:.2e}, an exactly rounded h "
        f"{need['exact_h']:.2e}; plan (down splits, "
        f"gate/up tail units, their splits, scratch floats) {plan}")
    del got, want
    kernel = time_ms(lambda: fm.fused_mlp(x, wg, wu, wd))
    plain = time_ms(lambda: fm.fused_mlp_plain(x, wg, wu, wd),
                    iters=3, warmup=1)
    silu = torch.nn.functional.silu
    library = time_ms(lambda: torch.matmul(
        silu(torch.matmul(x, wg)) * torch.matmul(x, wu), wd))
    nbytes = 2 * (3 * d * f + 2 * t * d)
    bms, by = bound_ms(nbytes, 6.0 * t * d * f, "bfloat16")
    log(f"[mlp bf16 T={t}] kernel {kernel:.4f} ms, plain {plain:.4f} ms, "
        f"3x matmul {library:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"name": "fused_mlp", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_mlp.cu",
            "replaces": "src/repro/kernels/fused_mlp.py:47",
            "max_abs_err": err, "max_abs_err_f32": err32,
            "tolerance": "bf16 atol 1e-3 + rtol 8e-3 of each value, fp32 "
                         "atol 1e-5",
            "bf16_worst_error_of_limit": bf16_excess,
            "bf16_dropped_tile_error_of_limit": drop,
            "bf16_partials_error_of_limit": partials_bf16,
            "bf16_atol_needed": need,
            "plan": plan,
            "ms": kernel, "kernel_ms": kernel, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": library,
            "library": "matmul(silu(matmul(x,Wg))*matmul(x,Wu), Wd)"}


def _flash_inputs(gen, shape, dtype):
    b, s, t, hq, hkv, d = shape
    return tuple(torch.randn(sh, generator=gen, device="cuda").to(dtype)
                 for sh in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d)))


def phase_flash(rng):
    """Flash attention: (a) bf16 at the training shape, (b) fp32 at a
    small shape, (c) ragged / windowed / non-causal fp32 cases, (d) the
    gradients of the autograd.Function against autograd through the
    plain version; then times at the training shape."""
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    # (a) bf16, B = 1, S = T = 4096, Hq/Hkv = 40/8, D = 128, causal. Both
    # compute in fp32 from the same bf16 inputs and round the output to
    # bf16 once, so a correct kernel is off by at most one bf16 ulp of each
    # value (2^-7 of it at most); the limit is relative to each value, as a
    # row attending to n keys has |out| ~ sqrt(e / n), ~0.03 at mid rows.
    atol, rtol = 1e-5, 8e-3
    train_shape = (1, 4096, 4096, 40, 8, 128)
    q, k, v = _flash_inputs(gen, train_shape, torch.bfloat16)
    got = fa.flash_attention(q, k, v, causal=True).float()
    want = fa.flash_attention_plain(q, k, v, causal=True).float()
    torch.cuda.synchronize()

    def excess(a):                    # worst |a - want| / (atol + rtol|want|)
        return ((a - want).abs() / (atol + rtol * want.abs())).max().item()

    err, bf16_excess = (got - want).abs().max().item(), excess(got)
    check(bool(torch.isfinite(got).all()), "flash output finite")
    check(bf16_excess <= 1.0, f"flash bf16 training shape: max abs err "
          f"{err}, worst error {bf16_excess:.3f}x atol {atol} + rtol {rtol}")
    # the same check rejects a defect of one tile: the plain version with
    # window 4032 drops up to 64 keys from the last 64 query rows only
    drop = excess(fa.flash_attention_plain(q, k, v, causal=True,
                                           window=4096 - 64).float())
    check(drop > 1.0, f"the bf16 check passes a version that drops keys "
                      f"(worst error {drop:.3f}x the limit)")
    log(f"[flash bf16 B=1 S=T=4096 40/8x128 causal] kernel vs plain "
        f"max_abs_err {err:.3e}, worst error {bf16_excess:.3f}x the limit "
        f"(atol {atol}, rtol {rtol}; reference rms "
        f"{want.pow(2).mean().sqrt().item():.3e}, max "
        f"{want.abs().max().item():.3e}); one dropped key tile would be "
        f"{drop:.1f}x the limit")
    del got, want
    # (b), (c): fp32, 2e-6 as tests/test_kernels.py:33
    cases = [((2, 256, 256, 8, 2, 64), True, 0, "small causal GQA"),
             ((1, 100, 77, 4, 2, 16), True, 0, "ragged S > T"),
             ((1, 70, 133, 4, 4, 64), False, 30, "ragged non-causal window"),
             ((1, 200, 200, 4, 2, 64), True, 50, "causal window"),
             ((2, 96, 96, 2, 1, 32), False, 0, "non-causal")]
    err32 = 0.0
    for shape, causal, window, what in cases:
        a = _flash_inputs(gen, shape, torch.float32)
        e = (fa.flash_attention(*a, causal=causal, window=window)
             - fa.flash_attention_plain(*a, causal=causal, window=window)
             ).abs().max().item()
        check(e <= 2e-6, f"flash fp32 {what} {shape}: max abs err {e} > 2e-6")
        log(f"[flash f32 {what} {shape} causal={causal} window={window}] "
            f"max_abs_err {e:.3e} (atol 2e-6)")
        err32 = max(err32, e)
    # (d) gradients, 2e-5 / 2e-4 as tests/test_kernels.py:173
    grad_err = 0.0
    for shape, causal, window, what in (cases[0], cases[3]):
        leaves = [x.requires_grad_(True)
                  for x in _flash_inputs(gen, shape, torch.float32)]
        got_g = torch.autograd.grad((fa.flash_attention(
            *leaves, causal=causal, window=window) ** 2).mean(), leaves)
        want_g = torch.autograd.grad((fa.flash_attention_plain(
            *leaves, causal=causal, window=window) ** 2).mean(), leaves)
        for name, g, w in zip("qkv", got_g, want_g):
            ok = torch.allclose(g, w, atol=2e-5, rtol=2e-4)
            e = (g - w).abs().max().item()
            check(ok, f"flash d{name} {what}: max abs err {e} vs autograd "
                      f"of plain (atol 2e-5, rtol 2e-4)")
            grad_err = max(grad_err, e)
    log(f"[flash grads f32] autograd.Function vs autograd through plain: "
        f"max abs err {grad_err:.3e} (atol 2e-5, rtol 2e-4)")
    # times at the training shape (bf16): kernel, plain, SDPA, backward
    kernel = time_ms(lambda: fa.flash_attention(q, k, v, causal=True))
    plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal=True),
                    iters=3, warmup=1)
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = time_ms(lambda: sdpa(qs, ks, vs, is_causal=True,
                                   enable_gqa=True))
    del qs, ks, vs
    g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    backward = time_ms(lambda: fa.flash_attention_bwd(q, k, v, g,
                                                      causal=True),
                       iters=3, warmup=1)
    b, s, t, hq, hkv, d = train_shape
    pairs = b * s * (s + 1) // 2                 # live causal (q, k) pairs
    flops = 4.0 * hq * d * pairs
    nbytes = 2 * (2 * b * s * hq * d + 2 * b * t * hkv * d)  # q, out, k, v
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    # the kernel keeps P fp32 in P.V as two bf16 products, P_hi V + P_lo V:
    # 1.5x the tensor-core work of the function
    split_ms = bound_ms(nbytes, 1.5 * flops, "bfloat16")[0]
    log(f"[flash bf16 training shape] kernel {kernel:.4f} ms, plain "
        f"{plain:.4f} ms, sdpa {library:.4f} ms, bound {bms:.4f} ms ({by}, "
        f"{flops / 1e9:.1f} GFLOP; {split_ms:.4f} ms for the split P.V); "
        f"backward (plain softmax recompute) {backward:.4f} ms")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:124",
            "max_abs_err": err, "max_abs_err_f32": err32,
            "max_abs_err_grads_f32": grad_err,
            "tolerance": "bf16 atol 1e-5 rtol 8e-3; fp32 atol 2e-6; grads "
                         "atol 2e-5 rtol 2e-4",
            "bf16_worst_error_of_limit": bf16_excess,
            "bf16_dropped_tile_error_of_limit": drop,
            "ms": kernel, "kernel_ms": kernel, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "bound_split_p_ms": split_ms,
            "library_ms": library,
            "library": "scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True)",
            "backward_ms": backward}


def _ssd_inputs(gen, shape, dtype, *, model_decay=False):
    """x, dt, A, B, C for the SSD kernel. x, B and C are views into one
    (b, s, h p + 2 n) buffer, as ``mamba_forward`` hands them over.
    ``model_decay``: dt and A from the model's init formulas
    (``ssm.py::init_mamba``: dt = softplus(u + dt_bias), A = -exp(A_log));
    else the distributions of tests/test_kernels.py."""
    b, s, h, p, n = shape

    def rnd(*sh):
        return torch.randn(sh, generator=gen, device="cuda")

    buf = torch.cat([rnd(b, s, h * p) * 0.5, rnd(b, s, 2 * n) * 0.3],
                    dim=-1).to(dtype)
    x = buf[..., :h * p].reshape(b, s, h, p)
    bm, cm = buf[..., h * p:h * p + n], buf[..., h * p + n:]
    if model_decay:
        lin = torch.linspace(1e-3, 1e-1, h, device="cuda")
        dt_bias = torch.log(torch.expm1(lin))
        dt = torch.nn.functional.softplus(rnd(b, s, h) * 0.5 + dt_bias)
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
    else:
        dt = torch.nn.functional.softplus(rnd(b, s, h))
        A = -torch.exp(rnd(h))
    return x, dt, A, bm, cm


def phase_ssd(rng):
    """The SSD chunked scan: (a) bf16 at the serving path's prefill shape
    (b 1, s 1024, h 48, p 64, n 128, chunk 128), (b) fp32 at small shapes
    with a ragged chunk (s 77 at chunk 128) and several chunks (s 96 at
    chunk 32); then times at the path's shape."""
    from repro_torch.kernels import ssd_scan as sk
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(1 << 30)))
    # (a) both sides compute in fp32 from the same bf16 inputs and round y
    # once: one bf16 ulp of each value, the flash rule; the final state is
    # fp32 on both sides: 1e-4 of its largest value
    atol, rtol, h_rtol = 1e-5, 8e-3, 1e-4
    path = (1, 1024, 48, 64, 128)
    chunk = 128
    args = _ssd_inputs(gen, path, torch.bfloat16, model_decay=True)
    y, h_last = sk.ssd_scan(*args, chunk=chunk)
    want_y, want_h = sk.ssd_scan_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    y, want_y = y.float(), want_y.float()

    def excess(a, w):                 # worst |a - w| / (atol + rtol |w|)
        return ((a - w).abs() / (atol + rtol * w.abs())).max().item()

    err = (y - want_y).abs().max().item()
    bf16_excess = excess(y, want_y)
    h_err = ((h_last - want_h).abs().max() / want_h.abs().max()).item()
    check(bool(torch.isfinite(y).all() and torch.isfinite(h_last).all()),
          "ssd output finite")
    check(bf16_excess <= 1.0, f"ssd bf16 path shape: y max abs err {err}, "
          f"worst error {bf16_excess:.3f}x atol {atol} + rtol {rtol}")
    check(h_err <= h_rtol, f"ssd bf16 path shape: final state max err "
          f"{h_err:.3e} of its largest value > {h_rtol}")
    # the same check rejects a defect of the state passing: the last chunk
    # scanned from a zero state (its carried-state term dropped)
    tail = [a[:, -chunk:] for a in (args[0], args[1])]
    bad, _ = sk.ssd_scan_plain(tail[0], tail[1], args[2], args[3][:, -chunk:],
                               args[4][:, -chunk:], chunk=chunk)
    drop = excess(bad.float(), want_y[:, -chunk:])
    check(drop > 1.0, f"the bf16 check passes a scan that drops the carried "
                      f"state (worst error {drop:.3f}x the limit)")
    log(f"[ssd bf16 b=1 s=1024 h=48 p=64 n=128 chunk=128] kernel vs plain "
        f"y max_abs_err {err:.3e}, worst error {bf16_excess:.3f}x the limit "
        f"(atol {atol}, rtol {rtol}; reference rms "
        f"{want_y.pow(2).mean().sqrt().item():.3e}, max "
        f"{want_y.abs().max().item():.3e}); final state err {h_err:.3e} of "
        f"its max (<= {h_rtol}); a dropped carried state would be "
        f"{drop:.1f}x the limit")
    del y, want_y, bad
    # (b) fp32, 1e-4 as tests/test_kernels.py:118; final state 1e-4 relative
    cases = [((1, 77, 2, 64, 128), 128, "ragged single chunk q=77"),
             ((1, 96, 2, 16, 16), 32, "three chunks of 32"),
             ((2, 256, 3, 64, 32), 64, "reference sweep")]
    err32 = h_err32 = 0.0
    for shape, ck, what in cases:
        a = _ssd_inputs(gen, shape, torch.float32)
        gy, gh = sk.ssd_scan(*a, chunk=ck)
        wy, wh = sk.ssd_scan_plain(*a, chunk=ck)
        check(torch.allclose(gy, wy, atol=1e-4, rtol=1e-4),
              f"ssd fp32 {what} {shape}: y max abs err "
              f"{(gy - wy).abs().max().item()} > atol=rtol=1e-4")
        e = (gy - wy).abs().max().item()
        he = ((gh - wh).abs().max() / wh.abs().max()).item()
        check(he <= 1e-4, f"ssd fp32 {what}: final state err {he} > 1e-4")
        log(f"[ssd f32 {what} {shape} chunk={ck}] y max_abs_err {e:.3e} "
            f"(atol=rtol=1e-4), final state err {he:.3e} of its max")
        err32, h_err32 = max(err32, e), max(h_err32, he)
    # times at the path's shape (bf16); no PyTorch call computes the scan
    kernel = time_ms(lambda: sk.ssd_scan(*args, chunk=chunk))
    plain = time_ms(lambda: sk.ssd_scan_plain(*args, chunk=chunk),
                    iters=3, warmup=1)
    b, s, h, p, n = path
    q = chunk
    nc = s // q
    # each input read once, each output written once
    nbytes = (2 * (2 * b * s * h * p + 2 * b * s * n)   # x, y; B, C (bf16)
              + 4 * (b * s * h + h + b * h * p * n))    # dt, A; final state
    pairs = q * (q + 1) // 2                            # causal (i, j) a chunk
    flops = 2.0 * b * nc * (pairs * n                   # C B^T, once a chunk
                            + h * (pairs * p            # intra y
                                   + 2 * q * n * p))    # inter y, state
    bms, by = bound_ms(nbytes, flops, "bfloat16")
    log(f"[ssd bf16 path shape] kernel {kernel:.4f} ms, plain {plain:.4f} "
        f"ms, library none, bound {bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB "
        f"at 3.35 TB/s vs {flops / 1e9:.3f} GFLOP at the bf16 peak of "
        f"989 TFLOP/s; {flops / 67e12 * 1e3:.4f} ms at the fp32 CUDA-core "
        f"peak of 67 TFLOP/s); {b * h} blocks on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:65",
            "max_abs_err": err, "max_abs_err_f32": err32,
            "state_err_of_max": h_err, "state_err_of_max_f32": h_err32,
            "tolerance": "bf16 y atol 1e-5 rtol 8e-3; fp32 y atol=rtol="
                         "1e-4; final state 1e-4 of its max",
            "bf16_worst_error_of_limit": bf16_excess,
            "bf16_dropped_state_error_of_limit": drop,
            "ms": kernel, "kernel_ms": kernel, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
            "library": "none: no one PyTorch call computes the SSD scan"}


# ------------------------------------------------------------------ phase 4

def phase_parity():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(name="pal-dense", arch_type="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=128, dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=3)
    cuda = _to(cpu, "cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, size=(n,)).astype(np.int32)
               for n in (5, 23, 9, 40, 6)]
    engines = {}
    for dev, params in (("cpu", cpu), ("cuda", cuda)):
        eng = ServeEngine(cfg, params, slots=2, max_len=64,
                          chunk_tokens=16)
        for i, p in enumerate(prompts):
            eng.submit(i, p, max_new=6)
        eng.step()
        engines[dev] = (eng, eng.last_logits.detach().float().cpu())
    err = (engines["cpu"][1] - engines["cuda"][1]).abs().max().item()
    check(err <= 1e-4, f"f32 first-step logits card vs CPU: {err} > 1e-4")
    outs = {}
    for dev, (eng, _) in engines.items():
        res = eng.run()
        outs[dev] = {i: list(res[i].out) for i in res}
    check(outs["cpu"] == outs["cuda"],
          f"greedy streams differ: cpu {outs['cpu']} cuda {outs['cuda']}")
    check(engines["cuda"][0].stats["decode_backend"] == "kernel",
          "card engine did not take the kernel path")
    log(f"[parity f32, TF32 off] first-step logits max abs err card vs CPU "
        f"{err:.3e} (<= 1e-4); greedy streams identical over {len(prompts)} "
        f"requests")
    return err


def phase_parity_ssm():
    """mamba2-smoke in fp32 (TF32 off) through the port's split-path
    engine on the card and on the CPU: the first prefill's logits within
    1e-4 (a first request with max_new 1 finishes on its prefill, so the
    engine's last program is that prefill), then every greedy stream
    identical. Prompts satisfy the chunk precondition (<= 32 or a multiple
    of 32) and include two- and three-chunk prefills."""
    from repro_torch import kernels
    from repro_torch.configs import get_smoke
    from repro_torch.params import init_params
    from repro_torch.serve.engine import ServeEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke("mamba2-780m").with_(dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=7)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (64, 17, 32, 96, 9)]
    res, first = {}, {}
    for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
        eng = ServeEngine(cfg, params, slots=2, max_len=160)
        kernels.reset_launches()
        eng.submit(0, prompts[0], max_new=1)
        eng.step()
        first[dev] = eng.last_logits.detach().float().cpu()
        for i, p in enumerate(prompts[1:], 1):
            eng.submit(i, p, max_new=6)
        out = eng.run()
        res[dev] = {i: list(out[i].out) for i in out}
        want = cfg.num_layers * eng.stats["prefills"] if dev == "cuda" else 0
        check(kernels.launches()["ssd_scan"] == want,
              f"ssm parity on {dev}: {kernels.launches()} (ssd_scan "
              f"{want} = layers x prefills)")
    err = (first["cpu"] - first["cuda"]).abs().max().item()
    check(first["cpu"].shape == (1, 1, cfg.vocab_size),
          f"first prefill logits shape {tuple(first['cpu'].shape)}")
    check(err <= 1e-4, f"ssm f32 first-prefill logits card vs CPU: "
                       f"{err} > 1e-4")
    check(res["cpu"] == res["cuda"],
          f"ssm greedy streams differ: cpu {res['cpu']} cuda {res['cuda']}")
    log(f"[parity ssm f32, TF32 off] mamba2-smoke first-prefill logits max "
        f"abs err card vs CPU {err:.3e} (<= 1e-4); greedy streams identical "
        f"over {len(prompts)} requests")
    return err


def phase_train_parity():
    """One fp32 train step (remat on, attn_impl="auto": the flash kernel
    on the card, full attention on the CPU) on both devices: loss and
    gradients within 1e-4, TF32 off."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.strategy import Strategy
    from repro_torch.params import init_params
    from repro_torch.train import step
    from repro_torch.tree import flatten
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig(name="pal-dense", arch_type="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
                      vocab_size=128, dtype="float32", qk_norm=True)
    strat = Strategy(dtype="float32")
    cpu = init_params(cfg, device="cpu", seed=5)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, 128, size=(2, 160)).astype(np.int32))
    res = {}
    for dev, params in (("cpu", cpu), ("cuda", _to(cpu, "cuda"))):
        leaves = flatten(params)
        for t in leaves.values():
            t.requires_grad_(True)
        total, mets = step.make_loss_fn(cfg, strat)(
            params, {"tokens": tokens.to(dev)})
        grads = torch.autograd.grad(total, list(leaves.values()))
        res[dev] = (float(mets["loss"].detach()),
                    {k: g.cpu() for k, g in zip(leaves, grads)})
    loss_err = abs(res["cpu"][0] - res["cuda"][0])
    grad_err = max((res["cuda"][1][k] - g).abs().max().item()
                   for k, g in res["cpu"][1].items())
    check(loss_err <= 1e-4, f"f32 train loss card vs CPU: {loss_err} > 1e-4")
    check(grad_err <= 1e-4, f"f32 train grads card vs CPU: {grad_err} > 1e-4")
    log(f"[parity f32 train step, TF32 off] loss {res['cpu'][0]:.6f}: card "
        f"vs CPU err {loss_err:.3e}, grads max abs err {grad_err:.3e} "
        f"(<= 1e-4)")
    return {"loss_err": loss_err, "grad_err": grad_err}


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# ------------------------------------------------------------------ phase 5

def phase_main(seed: int):
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.serve.paging import pages_for
    from repro_torch.serve.step import page_bucket
    cfg = get_config("qwen3-14b")
    log(f"[main] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, "
        f"{cfg.param_count() / 1e9:.2f} B params")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = Session(cfg, device="cuda", seed=seed)
    eng = session.serve(slots=4, max_len=1024, page_size=16,
                        chunk_tokens=256)
    torch.cuda.synchronize()
    log(f"[main] weights + pool ready in {time.perf_counter() - t0:.1f}s "
        f"(kv pool {eng.kv_bytes() / 1e9:.2f} GB)")
    rng = np.random.default_rng(seed)
    lens = rng.integers(24, 701, size=6)
    lens[int(rng.integers(6))] = int(rng.integers(513, 701))  # > 2 chunks
    max_new = 16
    for rid, n in enumerate(lens):
        eng.submit(rid, rng.integers(0, cfg.vocab_size, size=(int(n),)),
                   max_new=max_new)
    buckets = {page_bucket(max(pages_for(min(int(n) + max_new - 1, 1024), 16)
                               for n in lens[:i + 1]), cap=64)
               for i in range(len(lens))}
    serving = ("paged_attention", "fused_mlp")
    kernels.reset_launches()
    step_s, prefill_step = [], []
    t0 = time.perf_counter()
    while eng.busy():
        s0 = time.perf_counter()
        chunk0 = eng.stats["prefill_chunk_tokens"]
        eng.step()
        step_s.append(time.perf_counter() - s0)
        prefill_step.append(eng.stats["prefill_chunk_tokens"] > chunk0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    res = eng.results()
    runs = eng.stats["mixed_steps"]
    for rid in range(len(lens)):
        r = res[rid]
        check(r.done and len(r.out) == max_new,
              f"request {rid} finished={r.done} with {len(r.out)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out),
              f"request {rid} tokens out of range")
    for name, n in counts.items():
        want = cfg.num_layers * runs if name in serving else 0
        check(n == want, f"{name}: {n} launches != {want} "
                         f"({cfg.num_layers} layers x {runs} program runs "
                         f"for the serving kernels, 0 for the others)")
    check(eng.stats["decode_traces"] <= len(buckets),
          f"{eng.stats['decode_traces']} program shapes > {len(buckets)} "
          f"page buckets")
    check(bool(torch.isfinite(eng.last_logits).all()), "finite logits")
    tokens = sum(len(res[r].out) for r in res)
    step_ms = np.asarray(step_s) * 1e3
    with_pf = np.asarray(prefill_step)
    out = {"layers": cfg.num_layers, "prompt_lens": [int(n) for n in lens],
           "max_new": max_new, "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall, "program_runs": runs,
           "step_p50_ms": float(np.percentile(step_ms, 50)),
           "step_max_ms": float(step_ms.max()),
           "prefill_steps": int(with_pf.sum()),
           "prefill_step_p50_ms": float(np.percentile(step_ms[with_pf], 50)),
           "decode_only_step_p50_ms": float(
               np.percentile(step_ms[~with_pf], 50)),
           "prefill_tokens": int(sum(lens)),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decode_traces": eng.stats["decode_traces"],
           "launches": counts}
    log(f"[main] {len(lens)} requests (prompts {out['prompt_lens']}), "
        f"{tokens} tokens in {wall:.2f}s = {out['tokens_per_s']:.2f} tok/s; "
        f"{runs} program runs, step p50 {out['step_p50_ms']:.1f} ms (with "
        f"prefill rows {out['prefill_step_p50_ms']:.1f} ms over "
        f"{out['prefill_steps']} steps, decode only "
        f"{out['decode_only_step_p50_ms']:.1f} ms), max "
        f"{out['step_max_ms']:.1f} ms; peak memory "
        f"{out['peak_mem_gb']:.2f} GB; launches {counts}; "
        f"{eng.stats['decode_traces']} program shape(s)")
    return out, eng


#: phase 5's kernel groups: name -> substrings of the device kernel's name
#: (csrc/: the bf16 fused MLP is mlp_tma_wgmma_kernel, twice, with
#: mlp_tail_sum_kernel and mlp_split_sum_kernel; gemm_f32 is its fp32 pair)
SERVE_GROUPS = {"paged_attention": ("paged_attention_kernel",),
                "fused_mlp": ("mlp_tma_wgmma_kernel", "mlp_tail_sum_kernel",
                              "mlp_split_sum_kernel", "gemm_f32")}


def phase_profile(eng, rng, step_p50_ms: float, *, prompts=(600, 40),
                  max_new: int = 4, groups=SERVE_GROUPS, tag="profile",
                  steps=None, required=tuple(SERVE_GROUPS)):
    """Where the time goes: a serving engine under torch.profiler for one
    more pair of requests (phase 5: a 600-token prompt, so three 256-row
    chunks, and a 40-token one; 4 new tokens each), over its next
    ``steps`` steps (None: until it is idle). The profiler's one-time
    start-up is paid in a warm-up session before the window, to keep its
    host cost out. Fails if a ``required`` group matched no device
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    for rid, n in enumerate(prompts):
        eng.submit(100 + rid, rng.integers(0, eng.cfg.vocab_size, size=n),
                   max_new=max_new)
    return _profile_steps(eng, step_p50_ms, groups, tag, steps, required)


def _profile_steps(eng, step_p50_ms: float, groups, tag: str, steps=None,
                   required=()):
    """Run ``steps`` engine steps (None: until idle) under torch.profiler
    (device activity only). Device time is summed by kernel group
    (``groups``, then other GEMMs, then the rest); device ops are counted
    a step. The idle share is 1 - busy / window wall time; it is also
    given against the unprofiled run's step p50 of the same kind of
    step. If the profiler records no device time the breakdown reads "not
    measured"; if it does, every ``required`` group must have matched a
    device kernel (a renamed kernel would otherwise read 0 ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    steps0 = eng.stats["step_count"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        while eng.busy() and (steps is None
                              or eng.stats["step_count"] - steps0 < steps):
            eng.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_group = dict.fromkeys((*groups, "other_gemm", "other"), 0.0)
    kernels = {}
    ops = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        name = e.key
        low = name.lower()
        group = next((g for g, keys in groups.items()
                      if any(k in name for k in keys)), None)
        if group is None:
            group = "other_gemm" if any(
                w in low for w in ("gemm", "xmma", "nvjet", "cutlass")) \
                else "other"
        by_group[group] += ms
        kernels[name] = kernels.get(name, 0.0) + ms
        ops += e.count
    busy = sum(by_group.values())
    for g in required:
        check(not busy or by_group[g] > 0,
              f"[{tag}] no device kernel matched group {g!r} "
              f"({groups[g]}): kernels {sorted(kernels)}")
    n = eng.stats["step_count"] - steps0
    busy_step = busy / n
    out = {"steps": n, "window_ms": wall_ms, "device_busy_ms": busy,
           "device_busy_per_step_ms": busy_step,
           "device_ops_per_step": ops / n,
           "idle_share": (1 - busy / wall_ms) if busy else "not measured",
           "idle_share_vs_unprofiled_p50": (1 - busy_step / step_p50_ms)
           if busy else "not measured",
           "by_group_ms": by_group,
           "top_kernels_ms": sorted(kernels.items(), key=lambda kv: -kv[1])[:8]}
    if busy:
        share = ", ".join(f"{g} {ms:.1f} ms ({ms / busy:.0%})"
                          for g, ms in by_group.items())
        log(f"[{tag}] {n} steps in {wall_ms:.1f} ms wall, device busy "
            f"{busy:.1f} ms = {busy_step:.1f} ms a step, {ops / n:.0f} "
            f"device ops a step (idle share {out['idle_share']:.1%} of the "
            f"window, {out['idle_share_vs_unprofiled_p50']:.1%} of the "
            f"unprofiled step p50 {step_p50_ms:.1f} ms): {share}")
        for name, ms in out["top_kernels_ms"]:
            log(f"[{tag}]   {ms:9.2f} ms  {name[:90]}")
    else:
        log(f"[{tag}] the profiler recorded no device time: not measured")
    return out


# ------------------------------------------------------------------ phase 6

def phase_train(seed: int, steps: int = 6, layers: int = 4):
    """The TRAIN PATH at full width, depth cut to ``layers``; seq_len 4096
    unless it does not fit the card, then 2048 (said in the record)."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-14b").with_(num_layers=layers)
    for seq_len in (4096, 2048):
        try:
            return _train_run(cfg, seed, steps, seq_len)
        except torch.cuda.OutOfMemoryError as exc:
            if seq_len == 2048:
                raise
            log(f"[train] seq_len {seq_len} does not fit the card ({exc}); "
                f"cutting seq_len to 2048")
        # the failed run's tensors die with the exception's frames
        gc.collect()
        torch.cuda.empty_cache()


def _train_run(cfg, seed: int, steps: int, seq_len: int):
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.train.trainer import TrainConfig
    from repro_torch.tree import flatten
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = Session(cfg, device="cuda", seed=seed)
    trainer = session.train(TrainConfig(steps=steps, lr=3e-4, log_every=1,
                                        seed=seed),
                            global_batch=1, seq_len=seq_len)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in flatten(session.params).values())
    n_embed = session.params["embed"].numel()
    s = trainer.strategy
    log(f"[train] {cfg.name} cut to {cfg.num_layers} layers (width uncut: "
        f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads x "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"{cfg.dtype}, {n_params / 1e9:.3f} B params; strategy "
        f"{s.optimizer}, remat={s.remat}, attn_impl={s.attn_impl!r}; "
        f"params + AdamW state ready in {time.perf_counter() - t0:.1f}s")
    kernels.reset_launches()
    step_s = []
    for _ in range(steps):
        s0 = time.perf_counter()
        trainer.run(1)                 # ends in float(loss): a sync
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s0)
    counts = kernels.launches()
    hist = trainer.history
    check(len(hist) == steps, f"{len(hist)} logged steps != {steps}")
    for h in hist:
        check(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]),
              f"step {h['step']}: loss {h['loss']}, grad_norm "
              f"{h['grad_norm']}")
    want = {"flash_attention": cfg.num_layers * steps * 2,
            "fused_mlp": 0, "paged_attention": 0, "ssd_scan": 0}
    check(counts == want, f"train launches {counts} != {want} (flash: "
                          f"layers x steps x 2, forward + remat recompute)")
    peak = torch.cuda.max_memory_allocated()
    check(peak < card_bytes, f"peak {peak} >= card {card_bytes}")
    tokens = seq_len                                # global_batch 1
    p50 = float(np.percentile(step_s, 50))
    # model FLOPs: 6 N tokens (N without the embedding gather) + causal
    # attention, forward (4 S^2/2 Hq D a layer) and backward (2x forward)
    attn = 3 * 4.0 * cfg.num_heads * cfg.head_dim * seq_len * (seq_len + 1) \
        / 2 * cfg.num_layers
    model_flops = 6.0 * (n_params - n_embed) * tokens + attn
    out = {"layers": cfg.num_layers, "seq_len": seq_len,
           "seq_len_cut": seq_len != 4096, "global_batch": 1,
           "steps": steps, "params": n_params,
           "params_without_embed": n_params - n_embed,
           "step_s": step_s, "step_p50_s": p50,
           "first_step_s": step_s[0], "tokens_per_s": tokens / p50,
           "peak_mem_gb": peak / 1e9, "card_mem_gb": card_bytes / 1e9,
           "model_flops_per_step": model_flops,
           "model_flops_share_of_989T": model_flops / p50 / 989e12,
           "losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "launches": counts}
    log(f"[train] {steps} steps of 1 x {seq_len} tokens: step p50 "
        f"{p50 * 1e3:.1f} ms (first {step_s[0] * 1e3:.1f} ms), "
        f"{out['tokens_per_s']:.1f} tokens/s, peak memory "
        f"{out['peak_mem_gb']:.2f} GB of {out['card_mem_gb']:.2f} GB, model "
        f"FLOPs {model_flops / 1e12:.2f} T a step = "
        f"{out['model_flops_share_of_989T']:.2%} of 989 TFLOP/s; losses "
        f"{[round(x, 4) for x in out['losses']]}; launches {counts}")
    out["profile"] = _train_profile(trainer, p50)
    del trainer, session
    return out


def _train_profile(trainer, step_p50_s: float):
    """Where a train step's time goes: one more step under torch.profiler
    (host and device activity, after a warm-up profiler session as phase 5
    does). Device time is summed by kernel group, and by the step's parts
    (the ``record_function`` ranges ``train/step.py::PARTS``): each device
    event goes to the part whose host interval holds the start of the op
    that launched it, since the backward's ops run on autograd's own
    thread while its range stays open on the caller's; what no part holds
    is ``outside_parts``. "Not measured" if the profiler records no device
    time; if it does, the flash group must have matched a device kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.step import PARTS
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        trainer.run(1)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # the raw kineto events: each device event names the op that launched
    # it (linked_correlation_id = that op's correlation_id; runtime calls
    # carry a link of their own and are not ops)
    raw = prof.profiler.kineto_results.events()
    cpu, dev = DeviceType.CPU, DeviceType.CUDA
    spans = [(e.name(), e.start_ns(), e.end_ns()) for e in raw
             if e.device_type() == cpu and e.name() in PARTS]
    op_start = {e.correlation_id(): e.start_ns() for e in raw
                if e.device_type() == cpu and not e.linked_correlation_id()}
    # fp32 GEMMs are the attention backward's einsums (the model's own
    # matmuls are bf16); softmax kernels are its recompute
    groups = {"flash_attention": 0.0, "gemm_bf16": 0.0, "gemm_fp32": 0.0,
              "softmax": 0.0, "other": 0.0}
    parts = dict.fromkeys(PARTS + ("outside_parts",), 0.0)
    kernels = {}
    for e in raw:
        name = e.name()
        if e.device_type() != dev or e.is_user_annotation() or name in PARTS:
            continue                # a range's span on the device timeline
        ms = (e.end_ns() - e.start_ns()) / 1e6
        start = op_start.get(e.linked_correlation_id())
        parts[next((n for n, a, b in spans if start is not None
                    and a <= start <= b), "outside_parts")] += ms
        low = name.lower()
        if "flash_fwd" in name:     # flash_fwd_wgmma_kernel, flash_fwd_kernel
            group = "flash_attention"
        elif "f32f32" in low or "sgemm" in low:
            group = "gemm_fp32"
        elif any(w in low for w in ("gemm", "xmma", "nvjet", "cutlass")):
            group = "gemm_bf16"
        elif "softmax" in low:
            group = "softmax"
        else:
            group = "other"
        groups[group] += ms
        kernels[name] = kernels.get(name, 0.0) + ms
    busy = sum(groups.values())
    check(not busy or groups["flash_attention"] > 0,
          f"[train profile] no device kernel matched flash_fwd: kernels "
          f"{sorted(kernels)}")
    out = {"parts_device_ms": parts, "window_ms": wall_ms,
           "device_busy_ms": busy,
           "idle_share_vs_unprofiled_p50": (1 - busy / (step_p50_s * 1e3))
           if busy else "not measured",
           "by_group_ms": groups,
           "top_kernels_ms": sorted(kernels.items(),
                                    key=lambda kv: -kv[1])[:12]}
    if busy:
        share = ", ".join(f"{g} {ms:.1f} ms ({ms / busy:.0%})"
                          for g, ms in groups.items())
        log(f"[train profile] one step: {wall_ms:.1f} ms wall under the "
            f"profiler, device busy {busy:.1f} ms (idle share "
            f"{out['idle_share_vs_unprofiled_p50']:.1%} of the unprofiled "
            f"step p50 {step_p50_s * 1e3:.1f} ms): {share}")
        log("[train profile] device time by part: " + ", ".join(
            f"{n} {ms:.1f} ms" for n, ms in parts.items()))
        for name, ms in out["top_kernels_ms"]:
            log(f"[train profile]   {ms:9.2f} ms  {name[:90]}")
    else:
        log("[train profile] the profiler recorded no device time: not "
            "measured")
    return out


# ------------------------------------------------------------------ phase 7

def phase_ssm(seed: int):
    """The SSM SERVING PATH: ``Session(get_config("mamba2-780m"),
    device="cuda").serve(slots=4, max_len=2048)`` at full width (48
    layers, bf16, random weights from ``seed``): the split path, one
    exact-length prefill a request through the SSD kernel and one batched
    recurrent decode a step. Six requests of 1024, 640, 384, 256, 128 and
    77 prompt tokens (each <= 128 or a multiple of it: the reference's
    chunk precondition), 32 new tokens each. Counts are zeroed just before
    and read just after: the SSD kernel must have run layers x prefills
    times, the other kernels never."""
    from repro_torch import kernels
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.tree import flatten
    cfg = get_config("mamba2-780m")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    session = Session(cfg, device="cuda", seed=seed)
    eng = session.serve(slots=4, max_len=2048)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flatten(session.params).values())
    log(f"[ssm] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.ssm_heads} SSD heads x {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, {n_params / 1e6:.1f} M params; weights + states "
        f"ready in {time.perf_counter() - t0:.1f}s (decode state "
        f"{eng.kv_bytes() / 1e6:.1f} MB); paged={eng.paged}, "
        f"mixed={eng.mixed}")
    rng = np.random.default_rng(seed)
    lens = (1024, 640, 384, 256, 128, 77)
    max_new = 32
    for rid, n in enumerate(lens):
        eng.submit(rid, rng.integers(0, cfg.vocab_size, size=(n,)),
                   max_new=max_new)
    kernels.reset_launches()
    step_s, prefill_step = [], []
    t0 = time.perf_counter()
    while eng.busy():
        s0 = time.perf_counter()
        pf0 = eng.stats["prefills"]
        eng.step()
        step_s.append(time.perf_counter() - s0)
        prefill_step.append(eng.stats["prefills"] > pf0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launches()
    res = eng.results()
    prefills = eng.stats["prefills"]
    for rid in range(len(lens)):
        r = res[rid]
        check(r.done and len(r.out) == max_new,
              f"request {rid} finished={r.done} with {len(r.out)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.out),
              f"request {rid} tokens out of range")
    want = dict.fromkeys(counts, 0)
    want["ssd_scan"] = cfg.num_layers * prefills
    check(prefills == len(lens) and counts == want,
          f"ssm launches {counts} != {want} ({cfg.num_layers} layers x "
          f"{prefills} prefills for the SSD kernel, 0 for the others)")
    check(eng.stats["prefill_traces"] == len(set(lens)),
          f"prefill_traces {eng.stats['prefill_traces']} != "
          f"{len(set(lens))} distinct prompt lengths")
    check(eng.stats["decode_traces"] == 1,
          f"decode_traces {eng.stats['decode_traces']} != 1")
    check(bool(torch.isfinite(eng.last_logits).all()), "finite logits")
    tokens = sum(len(res[r].out) for r in res)
    step_ms = np.asarray(step_s) * 1e3
    with_pf = np.asarray(prefill_step)
    out = {"layers": cfg.num_layers, "params": n_params,
           "prompt_lens": list(lens), "max_new": max_new, "tokens": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "steps": len(step_s), "prefills": prefills,
           "step_p50_ms": float(np.percentile(step_ms, 50)),
           "step_max_ms": float(step_ms.max()),
           "prefill_steps": int(with_pf.sum()),
           "prefill_step_p50_ms": float(np.percentile(step_ms[with_pf], 50)),
           "decode_only_step_p50_ms": float(
               np.percentile(step_ms[~with_pf], 50)),
           "prefill_tokens": int(sum(lens)),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "decode_traces": eng.stats["decode_traces"],
           "prefill_traces": eng.stats["prefill_traces"],
           "launches": counts}
    log(f"[ssm] {len(lens)} requests (prompts {list(lens)}), {tokens} tokens "
        f"in {wall:.2f}s = {out['tokens_per_s']:.2f} tok/s; {len(step_s)} "
        f"steps, step p50 {out['step_p50_ms']:.1f} ms (with a prefill "
        f"{out['prefill_step_p50_ms']:.1f} ms over {out['prefill_steps']} "
        f"steps, decode only {out['decode_only_step_p50_ms']:.1f} ms), max "
        f"{out['step_max_ms']:.1f} ms; peak memory {out['peak_mem_gb']:.2f} "
        f"GB; launches {counts}; prefill_traces "
        f"{eng.stats['prefill_traces']}, decode_traces "
        f"{eng.stats['decode_traces']}")
    # one more pair (512 and 77 tokens, 12 new each): the admission step
    # (two prefills and a decode) and the decode-only steps after it are
    # profiled apart, each against the unprofiled p50 of its kind
    groups = {"ssd_scan": ("ssd_scan_kernel",)}
    out["profile"] = phase_profile(
        eng, rng, out["prefill_step_p50_ms"], prompts=(512, 77),
        max_new=12, groups=groups, tag="ssm profile: admission step",
        steps=1, required=("ssd_scan",))
    out["profile_decode"] = _profile_steps(
        eng, out["decode_only_step_p50_ms"], groups,
        "ssm profile: decode-only steps")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_all = time.perf_counter()
    smi = phase_card()
    record = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "seed": args.seed}
    record["build_s"], record["sass"] = phase_build()
    rng = np.random.default_rng(args.seed)
    kernels = [phase_attention(rng), phase_mlp(rng), phase_flash(rng),
               phase_ssd(rng)]
    record["parity_logits_err"] = phase_parity()
    record["parity_ssm_logits_err"] = phase_parity_ssm()
    record["parity_train"] = phase_train_parity()
    main_run, eng = phase_main(args.seed)
    record["main"] = main_run
    record["profile"] = phase_profile(eng, rng, main_run["step_p50_ms"])
    del eng                               # free the serving session
    gc.collect()
    torch.cuda.empty_cache()
    record["train"] = phase_train(args.seed)
    gc.collect()                          # the trainer died with phase 6
    torch.cuda.empty_cache()
    record["ssm"] = phase_ssm(args.seed)
    runs = {"flash_attention": record["train"], "ssd_scan": record["ssm"]}
    for k in kernels:
        k["launches"] = runs.get(k["name"], main_run)["launches"][k["name"]]
    record["kernels"] = kernels
    record["total_s"] = time.perf_counter() - t_all
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    log(f"[done] {record['total_s']:.1f}s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
