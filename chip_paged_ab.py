#!/usr/bin/env python3
"""Time the bf16 paged-attention kernel of two checkouts on one card, in
turns (A, B, B, A), for a before/after comparison within one call.

    python3 chip_paged_ab.py OLD_TREE NEW_TREE [--iters 50]

Each turn runs in its own process, with ``OLD_TREE/src`` or
``NEW_TREE/src`` first on the path, so each tree builds and loads its own
kernel (imported before this checkout's ``chip_smoke``, whose inputs
and timers every turn uses: ``attention_inputs``, ``graph_ms``,
``device_us``, the same seed in every turn; Qwen3-14B heads, 16-token
pages, eight layer pools in rotation so the pools are not warm in L2).
For each mix: the mean time of a call by CUDA-graph replay (three
repeats of ``--iters`` replays) and each launch's device time from
torch.profiler. Mixes: phase 5's T = 256
row mix and its decode-only step, phase 5b's four-row split decode, and
four lone 4096-key decode rows. Prints one JSON line a turn.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def turn(tree: str, iters: int) -> dict:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch.kernels import paged_attention as pa
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import chip_smoke as cs              # this checkout's inputs and timers
    mixes = {"T256": dict(rows=cs.MIX_T256),
             "decode_only": dict(rows=cs.MIX_DECODE),
             "split4": dict(rows=cs.MIX_SPLIT),
             "decode_4x4096": dict(ctx=(4096,) * 4,
                                   rows=([0, 1, 2, 3], [4095] * 4),
                                   width=256, n_pages=1025)}
    out = {"tree": str(tree)}
    for name, kw in mixes.items():
        rng = np.random.default_rng(0)
        q, pools, tab, pos, *_ = cs.attention_inputs(
            rng, torch.bfloat16, n_layers_copies=8, **kw)
        calls = [lambda kv=kv: pa.paged_attention(q, *kv, tab, pos)
                 for kv in pools]
        out[name] = {
            "graph_ms": [cs.graph_ms(calls, iters=iters) for _ in range(3)],
            "device_us_by_launch": cs.device_us(calls[0])}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn, args.iters)), flush=True)
        return
    for tree in (args.old, args.new, args.new, args.old):
        res = subprocess.run([sys.executable, __file__, args.old, args.new,
                              "--iters", str(args.iters), "--turn", tree],
                             capture_output=True, text=True)
        if res.returncode:
            sys.stderr.write(res.stderr)
            sys.exit(res.returncode)
        print(res.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
