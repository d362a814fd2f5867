"""Serving launcher of the port: spin up the engine through
``repro_torch.api.Session`` and stream a synthetic batch of requests
through it — the counterpart of ``python -m repro.launch.serve`` in batch
mode. A dense or MoE decoder (``--arch olmoe-1b-7b``; ``--arch
kimi-k2-1t-a32b`` on its smoke config only) runs the paged mixed-step
engine by default, ``--no-mixed`` the split prefill/decode path on the
paged pool and ``--dense`` the split path on the dense per-slot layout
(the mixed step needs the pool); the SSM family (``--arch
mamba2-780m``) and the hybrid (``--arch zamba2-1.2b``) run the split
path on the dense layout. The enc-dec audio family (``--arch
whisper-tiny``) serves like a dense decoder, each request with its own
``(encoder_ctx, d_model)`` frames drawn from ``--seed``; the VLM
(``--arch llama-3.2-vision-90b``) serves on the split path over the
dense layout (not pageable, as in the reference), each request with its
own ``(num_image_tokens, d_model)`` images drawn from ``--seed``.
``--full`` needs more than one card for Llama-3.2-Vision-90B uncut (~177
GB of bf16 weights): on one H100 cut its depth with ``--layers``.

    # on the card, full-width Qwen3-14B (random weights from --seed)
    PYTHONPATH=src python -m repro_torch.launch.serve --full \\
        --slots 4 --max-len 1024 --chunk-tokens 256 --requests 6

    # on the card, the split path: on the pool, and on the dense layout
    PYTHONPATH=src python -m repro_torch.launch.serve --full --no-mixed \\
        --slots 4 --max-len 1024 --requests 6
    PYTHONPATH=src python -m repro_torch.launch.serve --full --dense \\
        --slots 4 --max-len 1024 --requests 6

    # on the card, prefix sharing + lazy growth over a shared system prompt
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --slots 4 --max-len 1024 --requests 8 --shared-prefix 512 \
        --prefix-cache --lazy --kv-pages 56

    # on the card, full-width OLMoE-1B-7B (16 layers, 64 experts, top 8)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        --full --slots 4 --max-len 1024 --chunk-tokens 256 --requests 6

    # on the card, full-width Mamba2-780M and Zamba2-1.2B
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --full --slots 4 --max-len 2048 --requests 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --full --slots 4 --max-len 2048 --requests 6

    # on the card, full-width whisper-tiny (4 + 4 layers, 1500 frames)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --full --slots 8 --max-len 448 --chunk-tokens 256 --requests 8

    # on the card, full-width Llama-3.2-Vision-90B cut to 4 of its 20
    # groups (16 self + 4 cross layers, ~40 GB of weights)
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama-3.2-vision-90b --full --layers 20 --slots 4 \
        --max-len 1024 --requests 6 --max-new 16

    # on the CPU, the reduced configs in float32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --dense
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --slots 4 --requests 4 --max-new 24 --shared-prefix 32 \
        --prefix-cache --lazy --kv-pages 6
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        --device cpu --no-mixed
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
        --device cpu --no-mixed
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch llama-3.2-vision-90b --device cpu

Without ``--full`` the arch's smoke config runs in float32, as the JAX
launcher does; ``--full`` takes the arch's full ``CONFIG`` in its own
dtype (bfloat16). The device picks the kernel path (CUDA: the
hand-written kernels; CPU: their plain versions). ``--prefix-cache``
and ``--lazy`` serve on the pool, on the mixed and the split path (on
the SSM family, the hybrid or with ``--dense`` they raise the
reference's ValueError). ``--spec-k K --drafter ngram|model`` turns on
speculative decode on the mixed step (greedy only). ``--serve`` skips the synthetic
batch and serves the engine over HTTP (``POST /generate``, ``GET
/metrics``, ``GET /healthz``; ``--port 0`` picks a free port) until
ctrl-c, with the watchdog at ``--watchdog-timeout`` seconds.

``--tp N`` serves any family tensor-parallel over N ranks (a Mamba2
block by whole heads; the VLM's cross layers by head like its self
layers), one process a rank as ``torchrun
--nproc-per-node N`` starts them (each rank builds only its shards;
serve/engine.py). The process group's backend is ``--backend`` (default
NCCL on CUDA, gloo on the CPU; ranks sharing one card need gloo: NCCL
refuses two ranks on one device). Rank 0 prints. ``--dp M`` serves M
replicas behind a ``ReplicaRouter`` (serve/parallel.py): in this one
process at tp 1 — on ``--device`` M times where it names one device
(``cpu``, ``cuda:0``: the replicas share its weights), on the visible
cards of a bare ``cuda`` — and under ``torchrun --nproc-per-node M*N``
with ``--tp N``, each process serving its row's replica. The report
sums the replicas' counters and gives the worst replica's program-shape
count. ``--serve`` with ``--tp`` (and ``--dp``) serves online on every
rank: rank 0 binds the HTTP port and takes the requests, and every rank
steps on the host events it broadcasts before each step
(serve/driver.py); a ctrl-c reaches every rank, and a follower leaves
only when rank 0 has sent "stop".

    # two ranks on the CPU, or sharing one card over gloo
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --tp 2 --device cpu --requests 3
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --tp 2 --backend gloo --full --slots 4 --max-len 1024 --requests 6
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch olmoe-1b-7b --tp 2 --backend gloo --full --slots 4 \
        --max-len 1024 --requests 6
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --arch llama-3.2-vision-90b --tp 2 --backend gloo --full \
        --layers 20 --slots 4 --max-len 1024 --requests 6

    # two replicas in one process (on the CPU; on card 0), and dp 2 x tp 2
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --dp 2
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda:0 \
        --dp 2 --full --slots 4 --max-len 1024 --requests 6
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --dp 2 --tp 2 --device cpu --requests 6

    # on the card, speculative decode with the prompt-lookup drafter
    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --slots 4 --max-len 1024 --requests 8 --spec-k 4

    # on the CPU, online over HTTP
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --serve --port 8000 --spec-k 2

    # online at tp 2 (rank 0 binds port 8000), and at dp 2 x tp 2
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --tp 2 --backend gloo --device cpu --serve --port 8000
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --dp 2 --tp 2 --device cpu --serve --port 8000
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.api import Session
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.serve.speculative import SpecConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-14b")
    ap.add_argument("--full", action="store_true",
                    help="serve the arch's full CONFIG in its own dtype "
                         "(default: the float32 smoke config)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (width uncut)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the workload")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 = temperature sampling")
    ap.add_argument("--dense", action="store_true",
                    help="dense per-slot KV layout instead of the paged "
                         "pool (served by the split path)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="shared pool size in pages (default: "
                         "slots*ceil(max_len/page_size))")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share KV pages of common prompt prefixes")
    ap.add_argument("--lazy", action="store_true",
                    help="reserve pages as the context grows (copy-on-"
                         "write, preemption when the pool runs dry)")
    ap.add_argument("--no-mixed", action="store_true",
                    help="legacy split prefill/decode instead of the "
                         "mixed token-slot step")
    ap.add_argument("--chunk-tokens", type=int, default=256,
                    help="mixed step token budget shared by decode tokens "
                         "and prefill chunks (must be >= --slots)")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="speculative decode: draft up to K tokens per "
                         "slot per step and verify them in the same "
                         "mixed step (0 disables; greedy only)")
    ap.add_argument("--drafter", choices=("ngram", "model"),
                    default="ngram",
                    help="--spec-k drafter: 'ngram' prompt lookup or "
                         "'model' (a tiny greedy draft model with fresh "
                         "weights)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="prepend the same N-token system prompt to every "
                         "request")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: run under torchrun "
                         "--nproc-per-node N, one process a rank")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="--tp: the process group's backend (default "
                         "nccl on cuda, gloo on cpu; ranks sharing one "
                         "card need gloo)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel replicas behind a ReplicaRouter "
                         "(one process at --tp 1; under torchrun with "
                         "dp*tp processes otherwise)")
    ap.add_argument("--serve", action="store_true",
                    help="ONLINE mode: skip the synthetic batch and "
                         "serve over HTTP (POST /generate, GET /metrics, "
                         "GET /healthz) until ctrl-c")
    ap.add_argument("--port", type=int, default=8000,
                    help="--serve: TCP port to bind (0 picks a free one)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="--serve: bind address")
    ap.add_argument("--watchdog-timeout", type=float, default=30.0,
                    help="--serve: seconds one engine step may run before "
                         "the watchdog cancels and requeues the active "
                         "slots (<= 0 disables it)")
    ap.add_argument("--trace-level", type=int, choices=(0, 1, 2),
                    default=1,
                    help="tracer detail: 0 off, 1 lifecycle events + "
                         "per-step phase records, 2 adds per-chunk events")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace_event JSON of the "
                         "run to PATH")
    args = ap.parse_args(argv)
    if args.tp > 1:
        _join_ranks(args)
    lead = args.tp == 1 or torch.distributed.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)

    cfg = get_config(args.arch) if args.full \
        else get_smoke(args.arch).with_(dtype="float32")
    if args.layers:
        cfg = cfg.with_(num_layers=args.layers)
    session = Session(cfg, device=args.device, seed=args.seed)
    spec = SpecConfig(k=args.spec_k, drafter=args.drafter) \
        if args.spec_k > 0 else None
    one = torch.device(args.device)
    devices = [one] * args.dp if args.dp > 1 and args.tp == 1 and (
        one.type == "cpu" or one.index is not None) else None
    serve_kw = dict(
        tp=args.tp, dp=args.dp, devices=devices, slots=args.slots,
        max_len=args.max_len,
        temperature=args.temperature,
        paged=False if args.dense else None, page_size=args.page_size,
        kv_pages=args.kv_pages, prefix_cache=args.prefix_cache,
        lazy=args.lazy, mixed=False if args.no_mixed else None,
        chunk_tokens=args.chunk_tokens, spec=spec,
        trace_level=args.trace_level)
    if args.serve:
        wt = args.watchdog_timeout if args.watchdog_timeout > 0 else None
        server = session.serve_http(host=args.host, port=args.port,
                                    watchdog_timeout=wt, **serve_kw)
        log(f"serving {cfg.name} on {server.url} (POST /generate, GET "
              f"/metrics, GET /healthz, GET /debug/flight, GET "
              f"/debug/trace; watchdog {'off' if wt is None else f'{wt}s'})"
              f" — ctrl-c to stop", flush=True)
        if not server.driver.lead:
            # a follower rank replays rank 0's events until rank 0 sends
            # "stop": the ctrl-c that reaches it too must not end it first
            while True:
                try:
                    server.driver.wait()
                    return None
                except KeyboardInterrupt:
                    continue
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            if args.trace_out:
                server.driver.export_trace(args.trace_out)
                log(f"trace written to {args.trace_out}", flush=True)
            server.close(drain=False)
        return None
    eng = session.serve(**serve_kw)

    rng = np.random.default_rng(args.seed)
    system = rng.integers(0, cfg.vocab_size, size=(args.shared_prefix,))
    for rid in range(args.requests):
        n = int(rng.integers(4, 16))
        # an enc-dec request carries synthetic frame embeddings, standing
        # in for the stubbed mel + conv frontend (the reference's draw)
        frames = (rng.standard_normal((cfg.encoder_ctx, cfg.d_model))
                  .astype(np.float32) if cfg.arch_type == "audio" else None)
        # a VLM request carries synthetic patch embeddings, standing in
        # for the stubbed ViT + projector (the reference's draw)
        images = (rng.standard_normal((cfg.num_image_tokens, cfg.d_model))
                  .astype(np.float32) if cfg.arch_type == "vlm" else None)
        prompt = np.concatenate(
            [system, rng.integers(0, cfg.vocab_size, size=(n,))])
        eng.submit(rid, prompt, max_new=args.max_new, frames=frames,
                   images=images)

    t0 = time.perf_counter()
    results = eng.run()
    # a dp > 1 serve() returns a ReplicaRouter: its stats sum the
    # replicas' counters, and its first replica describes the layout
    rep = eng.engines[0] if hasattr(eng, "engines") else eng
    if rep.device.type == "cuda":
        torch.cuda.synchronize(rep.device)
    dt = time.perf_counter() - t0
    total = sum(len(r.out) for r in results.values())
    st = eng.stats
    # program-shape counts are per replica: the worst replica's
    per = st.get("replicas", [st])
    traces = {k: max(r[k] for r in per)
              for k in ("decode_traces", "prefill_traces")}
    layout = (f"paged/{rep.page_size}tok-pages" if rep.paged
              else "dense slot table") + \
        ("" if rep.mixed else ", split prefill/decode")
    par = "" if args.tp == 1 else (
        f", tp {rep.tp} over {torch.distributed.get_backend()}, "
        f"{eng.per_device_kv_bytes() / 1e6:.1f}MB of it a rank")
    if args.dp > 1:
        homes = [eng.replica_of(r) for r in results]
        par += (f", dp {args.dp}, requests a replica "
                f"{[homes.count(r) for r in range(args.dp)]}")
    log(f"served {len(results)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s on {rep.device}, {args.slots} slots, "
          f"{layout}, {st['decode_backend']} path, "
          f"state {eng.kv_bytes() / 1e6:.1f}MB, {st['decode_steps']} decode "
          f"steps, {traces['decode_traces']} decode shapes, "
          f"{traces['prefill_traces']} prefill lengths a replica{par})")
    if rep.paged:
        log(f"  pool: peak {st['peak_pages']}/{rep.kv_pages * args.dp} "
              f"pages, "
              f"prefix hit/miss {st['prefix_hit_blocks']}/"
              f"{st['prefix_miss_blocks']} blocks "
              f"(+{st['prefix_tail_hits']} tail), "
              f"{st['preemptions']} preemptions, "
              f"{st['cow_copies']} CoW copies, "
              f"{st['prefix_evictions']} evictions")
    if spec is not None:
        drafted, accepted = st["spec_drafted"], st["spec_accepted"]
        per_step = ((st["decode_tokens"] - st["prefills"])
                    / max(st["decode_slot_steps"], 1))
        log(f"  spec: k={args.spec_k} drafter={args.drafter}, "
              f"{accepted}/{drafted} drafts accepted "
              f"({accepted / max(drafted, 1):.2f}), "
              f"{per_step:.2f} tokens per (decode step, slot)")
    if args.trace_out:
        obj = eng.export_trace(args.trace_out)
        log(f"  trace: {len(obj['traceEvents'])} events written to "
              f"{args.trace_out}")
    for rid in sorted(results):
        r = results[rid]
        log(f"  req {rid}{'' if r.done else ' [truncated]'}: {r.out}")
    return results


def _join_ranks(args):
    """Join the process group ``torchrun`` set up in the environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) with
    ``--backend``, and put a CUDA rank on its card (``LOCAL_RANK`` modulo
    the cards there are)."""
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    if not torch.distributed.is_initialized():
        torch.distributed.init_process_group(
            args.backend or ("nccl" if cuda else "gloo"))


if __name__ == "__main__":
    try:
        main()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
