#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero; no result line is printed then):

1. the card: ``torch.cuda.is_available()`` or exit 1; name and power
   limit from ``nvidia-smi``;
2. build every kernel of the serving path from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, started together) and print ptxas's
   register / shared-memory / spill lines;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes of the main path (bf16) and at a small fp32 shape, with the
   tolerance stated beside each; time kernel, plain version and one
   PyTorch library call computing the same function (never called by the
   port) with CUDA events, and compute each kernel's bound from these
   inputs and NVIDIA's H100 SXM data sheet;
4. a tiny float32 config through the port's engine on the card and on
   the CPU: first-step logits within 1e-4, greedy streams identical
   (TF32 off);
5. the MAIN PATH: ``Session(get_config("qwen3-14b"), device="cuda")
   .serve(slots=4, max_len=1024, page_size=16, chunk_tokens=256)`` at full
   width with random weights from ``--seed``, 6 requests of 24-700 prompt
   tokens and 16 new tokens each. Launch counts are zeroed just before and
   read just after: each kernel must have run ``layers x program runs``
   times. Prints tokens/s, step p50 and peak memory; then one more pair of
   requests runs under ``torch.profiler`` for the device-time breakdown.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
The full record also goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
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


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    dt = time.perf_counter() - t0
    log(f"[build] both kernels built and loaded in {dt:.1f}s")
    for name, text in build.PTXAS_LOG.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "smem")):
                log(f"[ptxas {name}] {line.strip()}")
    return dt


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
    # bf16 at the main path's shape, weights at the init scales
    t, d, f = 256, 5120, 17408
    bf = torch.bfloat16
    x = torch.randn((t, d), generator=gen, device="cuda").to(bf)
    wg = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wu = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wd = (torch.randn((f, d), generator=gen, device="cuda")
          * (0.02 / math.sqrt(80))).to(bf)
    got = fm.fused_mlp(x, wg, wu, wd)
    want = fm.fused_mlp_plain(x, wg, wu, wd)
    err = (got.float() - want.float()).abs().max().item()
    check(bool(torch.isfinite(got).all()), "fused MLP output finite")
    check(torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2),
          f"fused MLP bf16: max abs err {err} > 2e-2")
    log(f"[mlp bf16 T={t} d={d} f={f}] kernel vs plain max_abs_err "
        f"{err:.3e} (atol=rtol=2e-2; |ref| max "
        f"{want.float().abs().max().item():.3e})")
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
            "tolerance": "bf16 atol=rtol=2e-2, fp32 atol 1e-5",
            "ms": kernel, "kernel_ms": kernel, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": library,
            "library": "matmul(silu(matmul(x,Wg))*matmul(x,Wu), Wd)"}


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
        check(n == cfg.num_layers * runs,
              f"{name}: {n} launches != {cfg.num_layers} layers x {runs} "
              f"program runs")
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


def phase_profile(eng, rng, step_p50_ms: float):
    """Where the time goes: the main-path engine under torch.profiler for
    one more pair of requests (a 600-token prompt, so three 256-row
    chunks, and a 40-token one; 4 new tokens each). Device time is summed
    by kernel group. The idle share is 1 - busy / window wall time (device
    activity only is recorded, and the profiler's one-time start-up is
    paid in a warm-up session before the window, to keep its host cost
    out); it is also given against the unprofiled main run's step p50.
    Diagnostic only: if the profiler records no device time the
    breakdown reads "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    for rid, n in enumerate((600, 40)):
        eng.submit(100 + rid, rng.integers(0, eng.cfg.vocab_size, size=n),
                   max_new=4)
    steps0 = eng.stats["mixed_steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        while eng.busy():
            eng.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"paged_attention": 0.0, "fused_mlp": 0.0, "other_gemm": 0.0,
              "other": 0.0}
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        name = e.key
        low = name.lower()
        if "paged_attention_kernel" in name:
            group = "paged_attention"
        elif "gemm_bf16" in name or "gemm_f32" in name:
            group = "fused_mlp"
        elif any(w in low for w in ("gemm", "xmma", "nvjet", "cutlass")):
            group = "other_gemm"
        else:
            group = "other"
        groups[group] += ms
        kernels[name] = kernels.get(name, 0.0) + ms
    busy = sum(groups.values())
    steps = eng.stats["mixed_steps"] - steps0
    busy_step = busy / steps
    out = {"steps": steps, "window_ms": wall_ms, "device_busy_ms": busy,
           "device_busy_per_step_ms": busy_step,
           "idle_share": (1 - busy / wall_ms) if busy else "not measured",
           "idle_share_vs_unprofiled_p50": (1 - busy_step / step_p50_ms)
           if busy else "not measured",
           "by_group_ms": groups,
           "top_kernels_ms": sorted(kernels.items(), key=lambda kv: -kv[1])[:8]}
    if busy:
        share = ", ".join(f"{g} {ms:.1f} ms ({ms / busy:.0%})"
                          for g, ms in groups.items())
        log(f"[profile] {steps} steps in {wall_ms:.1f} ms wall, device busy "
            f"{busy:.1f} ms = {busy_step:.1f} ms a step (idle share "
            f"{out['idle_share']:.1%} of the window, "
            f"{out['idle_share_vs_unprofiled_p50']:.1%} of the unprofiled "
            f"step p50 {step_p50_ms:.1f} ms): {share}")
        for name, ms in out["top_kernels_ms"]:
            log(f"[profile]   {ms:9.2f} ms  {name[:90]}")
    else:
        log("[profile] the profiler recorded no device time: not measured")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_all = time.perf_counter()
    smi = phase_card()
    record = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "seed": args.seed}
    record["build_s"] = phase_build()
    rng = np.random.default_rng(args.seed)
    kernels = [phase_attention(rng), phase_mlp(rng)]
    record["parity_logits_err"] = phase_parity()
    main_run, eng = phase_main(args.seed)
    record["main"] = main_run
    record["profile"] = phase_profile(eng, rng, main_run["step_p50_ms"])
    for k in kernels:
        k["launches"] = main_run["launches"][k["name"]]
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
