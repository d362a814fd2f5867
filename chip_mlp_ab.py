#!/usr/bin/env python3
"""Hold the bf16 fused MLP of two checkouts to the same inputs on one card,
in turns (A, B, B, A), for a before/after comparison within one call.

    python3 chip_mlp_ab.py OLD_TREE NEW_TREE [--iters 20]

Each turn runs in its own process, with ``OLD_TREE/src`` or
``NEW_TREE/src`` first on the path, so each tree builds and loads its own
kernel (imported before this checkout's ``chip_smoke``, whose seed sweep
and timer every turn uses). Qwen3-14B's MLP (d 5120, f 17408) with
weights at the init scales from one seed in every turn. For each turn:
``chip_smoke.mlp_seed_sweep`` (16 draws of x at each row count of the
split path and at T = 256: kernel vs plain, plain vs the exactly rounded
h, kernel vs that h, as multiples of the per-value limit atol 1e-3 +
rtol 8e-3); at T = 256 and 2048 the count of h values that the kernel
and the plain version round to another bf16 value than the exactly
rounded h (the kernel's h read back from the C entry's scratch); and the
kernel's time at T = 256 (CUDA events, three repeats of ``--iters``
calls). Prints one JSON line a turn.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path


def h_flips(torch, fm, build, x, wg, wu, wd) -> dict:
    """h values of the kernel and of the plain version that differ from h
    summed in fp64 and rounded once to bf16."""
    t, d = x.shape
    f = wg.shape[1]
    bf = torch.bfloat16
    h = torch.empty((t, f), dtype=bf, device="cuda")
    out = torch.empty((t, d), dtype=bf, device="cuda")
    *plan, scratch = fm.mlp_plan(t, d, f, torch.cuda.get_device_properties(
        0).multi_processor_count)
    partials = torch.empty((max(scratch, 1),), dtype=torch.float32,
                           device="cuda")
    rc = build.load("fused_mlp").fused_mlp_bf16(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
        h.data_ptr(), partials.data_ptr(), out.data_ptr(), t, d, f, *plan,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    build.check(rc, "fused_mlp")
    silu = torch.nn.functional.silu
    x32, x64 = x.float(), x.double()
    exact = (silu(x64 @ wg.double()) * (x64 @ wu.double())).to(bf)
    plain = (silu(x32 @ wg.float()) * (x32 @ wu.float())).to(bf)
    return {"h_values": h.numel(), "kernel": int((h != exact).sum()),
            "plain": int((plain != exact).sum())}


def turn(tree: str, iters: int) -> dict:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import fused_mlp as fm
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    import chip_smoke as cs             # this checkout's sweep and timer
    gen = torch.Generator(device="cuda").manual_seed(5)
    d, f, bf = 5120, 17408, torch.bfloat16
    wg = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wu = (torch.randn((d, f), generator=gen, device="cuda") * 0.02).to(bf)
    wd = (torch.randn((f, d), generator=gen, device="cuda")
          * (0.02 / math.sqrt(80))).to(bf)
    out = {"tree": str(tree),
           "sweep": cs.mlp_seed_sweep(wg, wu, wd, 1e-3, 8e-3), "flips": {}}
    for rows in (256, 2048):
        x = torch.randn((rows, d), generator=gen, device="cuda").to(bf)
        out["flips"][rows] = h_flips(torch, fm, build, x, wg, wu, wd)
    x = torch.randn((256, d), generator=gen, device="cuda").to(bf)
    out["ms_t256"] = [cs.time_ms(lambda: fm.fused_mlp(x, wg, wu, wd),
                                 iters=iters) for _ in range(3)]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--iters", type=int, default=20)
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
