"""Serving launcher of the port: spin up the paged mixed-step engine
through ``repro_torch.api.Session`` and stream a synthetic batch of
requests through it — the counterpart of ``python -m repro.launch.serve``
in batch mode.

    # on the card, full-width Qwen3-14B (random weights from --seed)
    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --slots 4 --max-len 1024 --chunk-tokens 256 --requests 6

    # on the CPU, the reduced config in float32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Without ``--full`` the arch's smoke config runs in float32, as the JAX
launcher does; ``--full`` takes the arch's full ``CONFIG`` in its own
dtype (bfloat16). The device picks the attention and MLP path (CUDA: the
hand-written kernels; CPU: their plain versions). Flags of features the
port has not reached (``--dense``, ``--no-mixed``, ``--prefix-cache``,
``--lazy``, ``--spec-k``, ``--tp``/``--dp``) raise NotImplementedError
naming their ROADMAP.md item; the online mode (``--serve``) waits for the
online stack.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import Session
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-14b")
    ap.add_argument("--full", action="store_true",
                    help="serve the arch's full CONFIG in its own dtype "
                         "(default: the float32 smoke config)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the workload")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 = temperature sampling")
    ap.add_argument("--dense", action="store_true",
                    help="dense per-slot KV layout (not ported yet)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="shared pool size in pages (default: "
                         "slots*ceil(max_len/page_size))")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="prefix sharing (not ported yet)")
    ap.add_argument("--lazy", action="store_true",
                    help="lazy page growth (not ported yet)")
    ap.add_argument("--no-mixed", action="store_true",
                    help="legacy split prefill/decode (not ported yet)")
    ap.add_argument("--chunk-tokens", type=int, default=256,
                    help="mixed step token budget shared by decode tokens "
                         "and prefill chunks (must be >= --slots)")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="speculative decode (not ported yet)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend the same N-token system prompt to every "
                         "request")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (not ported yet)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel replicas (not ported yet)")
    ap.add_argument("--trace-level", type=int, choices=(0, 1, 2),
                    default=1,
                    help="tracer detail: 0 off, 1 lifecycle events + "
                         "per-step phase records, 2 adds per-chunk events")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "run to PATH")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full \
        else get_smoke(args.arch).with_(dtype="float32")
    session = Session(cfg, device=args.device, seed=args.seed)
    spec = args.spec_k if args.spec_k > 0 else None
    eng = session.serve(
        tp=args.tp, dp=args.dp, slots=args.slots, max_len=args.max_len,
        temperature=args.temperature,
        paged=False if args.dense else None, page_size=args.page_size,
        kv_pages=args.kv_pages, prefix_cache=args.prefix_cache,
        lazy=args.lazy, mixed=False if args.no_mixed else None,
        chunk_tokens=args.chunk_tokens, spec=spec,
        trace_level=args.trace_level)

    rng = np.random.default_rng(args.seed)
    system = rng.integers(0, cfg.vocab_size, size=(args.shared_prefix,))
    for rid in range(args.requests):
        n = int(rng.integers(4, 16))
        prompt = np.concatenate(
            [system, rng.integers(0, cfg.vocab_size, size=(n,))])
        eng.submit(rid, prompt, max_new=args.max_new)

    t0 = time.perf_counter()
    results = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in results.values())
    st = eng.stats
    print(f"served {len(results)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {eng.device}, {args.slots} slots, "
          f"paged/{eng.page_size}tok-pages, {st['decode_backend']} path, "
          f"kv {eng.kv_bytes() / 1e6:.1f}MB, {st['decode_steps']} decode "
          f"steps, {st['decode_traces']} program shapes)")
    print(f"  pool: peak {st['peak_pages']}/{eng.kv_pages} pages")
    if args.trace_out:
        obj = eng.export_trace(args.trace_out)
        print(f"  trace: {len(obj['traceEvents'])} events written to "
              f"{args.trace_out}")
    for rid in sorted(results):
        r = results[rid]
        print(f"  req {rid}{'' if r.done else ' [truncated]'}: {r.out}")
    return results


if __name__ == "__main__":
    main()
