"""Multi-pod dry-run: trace every (architecture x input shape) as one rank
of the production meshes on ``torch.device("meta")``, and write each
record — memory, the roofline terms, the collectives by label — as JSON.
The port of ``repro/launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--optimized]

Nothing is allocated and nothing runs on a device: the kernels' wrappers
take the card's branch on meta tensors (``--device cuda``, the default:
their checks and allocations, each charging its ``cost``) or the plain
versions (``--device cpu``). The meshes are the reference's 16 x 16
("data", "model") and, with ``--multi-pod``, 2 x 16 x 16 ("pod", "data",
"model"), as mappings over a fake process group of 256 or 512 ranks
(``launch/mesh.py::fake_mesh``); the process must not have a process
group of its own. The roofline rates are the H100 data sheet's
(``core/costmodel.py::H100``): predictions, not measurements.
"""
from __future__ import annotations

import argparse
import json
import traceback
from pathlib import Path

from repro_torch.api import Session
from repro_torch.configs import (ARCH_NAMES, SHAPES, get_config,
                                 long_500k_policy)
from repro_torch.core.strategy import Strategy, mesh_axes

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

SWA_WINDOW = 4096


def production_mesh(*, multi_pod: bool = False) -> dict:
    """The reference's production layout as a mapping: 16 x 16 ("data",
    "model"); ``multi_pod`` adds a 2-pod axis in front."""
    return {"pod": 2, "data": 16, "model": 16} if multi_pod \
        else {"data": 16, "model": 16}


def effective_config(arch: str, shape_name: str):
    """Apply the long_500k policy: swa variant, run, or skip."""
    cfg = get_config(arch)
    if shape_name == "long_500k":
        pol = long_500k_policy(arch)
        if pol == "skip":
            return None, pol
        if pol in ("swa", "run") and cfg.num_heads > 0:
            # dense archs: SWA variant; hybrids: window on the shared block
            cfg = cfg.with_(sliding_window=SWA_WINDOW)
    return cfg, "ok"


def choose_strategy(cfg, shape, mesh, *, optimized: bool = False) -> Strategy:
    """Paper-faithful baseline: Megatron dp x tp (+ZeRO-1, remat, micro-
    batching — all used by the paper's case-studies). ``optimized`` layers
    on the beyond-paper knobs (sequence parallelism, FSDP, triangle attn).
    ``mesh``: a mapping or a ``DeviceMesh``."""
    axes = mesh_axes(mesh)
    dp = 1
    for a in ("pod", "data"):
        if a in axes:
            dp *= axes[a]
    st = Strategy(dtype=cfg.dtype)
    if shape.kind == "train":
        micro = max(1, shape.global_batch // dp) \
            if shape.global_batch % dp == 0 else 1
        st = st.with_(microbatches=micro)
        # the 1T MoE cannot hold AdamW fp32 states even ZeRO-1-sharded:
        # the planner switches it to adafactor + FSDP
        if cfg.param_count() > 4e11:
            st = st.with_(optimizer="adafactor", fsdp=True)
    else:
        st = st.with_(remat=False, microbatches=1)
        # big-model inference: params must shard over data too
        if cfg.param_count() * 2 / axes.get("model", 1) > 8e9:
            st = st.with_(fsdp=True)
    if optimized:
        # triangle attention skips dead causal blocks but its dynamic-bound
        # inner loop is not reverse-differentiable -> inference only
        st = st.with_(seq_parallel=True,
                      attn_impl="auto" if shape.kind == "train"
                      else "triangle",
                      grad_accum_dtype="bfloat16",
                      name=st.name + "+opt")
        if shape.kind == "prefill" and shape.global_batch % (4 * dp) == 0:
            # batch-chunked prefill bounds the activation / MoE-dispatch
            # working set
            st = st.with_(microbatches=4)
    return st


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              optimized: bool = False, mesh=None, strategy=None,
              verbose: bool = True, device: str = "cuda"):
    """Returns (record dict, lowered) or a skip record and None.

    Strategy selection + long_500k policy live here; the trace and the
    report are ``repro_torch.api.Session.lower``."""
    shape = SHAPES[shape_name]
    cfg, pol = effective_config(arch, shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    if cfg is None:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": f"skipped ({long_500k_policy(arch)} policy: "
                          "full-attention arch at 500k)"}, None
    if mesh is None:
        mesh = production_mesh(multi_pod=multi_pod)
    strategy = strategy or choose_strategy(cfg, shape, mesh,
                                           optimized=optimized)
    if optimized and shape.kind == "decode":
        # beyond-paper: context-parallel decode attention
        # (models/cp_attention.py) for seq-sharded caches
        cfg = cfg.with_(cp_decode=True)
    session = Session(cfg, strategy=strategy, device=device, mesh=mesh)
    return session.lower(shape, verbose=verbose, arch=arch,
                         mesh_name=mesh_name)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="beyond-paper strategy (SP + FSDP + triangle attn)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="whose branch the kernels' wrappers take on meta")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("give --arch and --shape, or --all")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    combos = ([(args.arch, args.shape)] if not args.all else
              [(a, s) for a in ARCH_NAMES for s in SHAPES])
    tag = "opt" if args.optimized else "base"
    mesh = production_mesh(multi_pod=args.multi_pod)
    failures = []
    for arch, shape in combos:
        try:
            rec, _ = lower_one(arch, shape, multi_pod=args.multi_pod,
                               optimized=args.optimized, mesh=mesh,
                               device=args.device)
        except Exception as e:  # a failure here is a bug in the system
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "status": "FAILED",
                   "error": str(e)[:2000]}
            failures.append((arch, shape))
        mesh_name = rec.get("mesh", "pod2x16x16" if args.multi_pod
                            else "pod16x16")
        fn = out_dir / f"{arch}__{shape}__{mesh_name}__{tag}.json"
        fn.write_text(json.dumps(rec, indent=2, default=str))
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)
    print("dry-run complete:", len(combos), "combos")


if __name__ == "__main__":
    main()
