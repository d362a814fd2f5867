"""Auto-parallelisation — the survey's §4 search problem, three ways.
The port's copy of ``repro/core/planner.py``: the same search space, the
same evaluations in the same order and the same random draws, so a plan
is the reference's field for field on the same hardware entry (the
default here is :data:`~repro_torch.core.costmodel.H100`).

Search space: legal (dp, tp, pp, microbatches, seq_parallel, remat)
assignments for a chip count, evaluated by core/costmodel.estimate (the
"strategy evaluation" half of §4). Search methods mirror paper Table 3:

  * "exhaustive"  — PipeDream-style full enumeration,
  * "dp"          — Alpa-style two-level: dynamic programming over pipeline
                    stage cuts (from the operator graph) x ILP-lite choice
                    of intra-op degree per stage,
  * "mcmc"        — FlexFlow-style Markov-chain Monte-Carlo random walk.

All three return the same Plan record so a benchmark can compare quality
vs. search cost — the standardisation the survey's Future Work section
asks for.
"""
from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.costmodel import (CostBreakdown, Degrees, H100,
                                        Hardware, estimate)
from repro_torch.core.opgraph import build_opgraph


@dataclass
class Plan:
    """A searched (or hand-specified) parallelisation strategy.

    Plans are EXECUTABLE: ``materialize(devices=...)`` turns the abstract
    ``Degrees`` into a validated ``(Strategy, mesh)`` pair that
    ``repro_torch.api.Session`` runs directly — the GSPMD/Alpa shape
    where one plan object flows from search into execution instead of
    dead-ending in a report.
    """
    degrees: Degrees
    cost: float                  # estimated step time (s)
    mfu: float
    fits: bool
    evaluations: int
    method: str
    stage_layers: Optional[List[List[int]]] = None
    breakdown: Optional[CostBreakdown] = None   # full cost-model terms

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d["degrees"] = dataclasses.asdict(self.degrees)
        d.pop("stage_layers")
        d.pop("breakdown")
        return d

    @classmethod
    def from_degrees(cls, cfg: ModelConfig, shape: ShapeConfig,
                     deg: Degrees, hw: Hardware = H100, *,
                     method: str = "manual") -> "Plan":
        """Wrap hand-picked degrees (paper tables, ablations) as a Plan so
        they share summary/materialize/row with searched plans."""
        cb = estimate(cfg, shape, deg, hw)
        return cls(degrees=deg, cost=cb.step_time, mfu=cb.mfu, fits=cb.fits,
                   evaluations=1, method=method, breakdown=cb)

    def summary(self, *, compact: bool = False) -> str:
        """Canonical pretty-printer (replaces the per-caller hand
        formatting in launch/train.py and the examples)."""
        d = self.degrees
        desc = (f"dp{d.dp} tp{d.tp} pp{d.pp} m{d.microbatches}"
                f"{' sp' if d.seq_parallel else ''}"
                f"{' ep' + str(d.ep) if d.ep > 1 else ''}")
        if compact:
            return desc
        return (f"plan[{self.method}] {desc} -> est {self.cost:.3f}s/step, "
                f"MFU {self.mfu:.1%}, fits={self.fits} "
                f"({self.evaluations} evals)")

    def materialize(self, devices: Union[None, int, Sequence] = None, *,
                    device_type: str = "cuda", **strategy_overrides):
        """Turn the plan into an executable ``(Strategy, mesh)`` pair.

        The degrees must exactly tile the devices (dp*pp*tp == their
        count) — the legality check that keeps a searched plan from
        silently running on the wrong mesh. One process is one rank
        (``torchrun``), so the devices are the ranks of the initialised
        default process group:

        * ``devices=None``: all of them (the world size; 1 when no group
          is initialised); ``devices=N``: the first N, which must be
          available;
        * one device needs no process group: ``mesh`` is None, the
          port's one-device Session;
        * N > 1: a ``DeviceMesh`` over ranks ``0 .. N-1`` on
          ``device_type`` (``launch/mesh.py``): ("data", "pipe",
          "model") = (dp, pp, tp) when ``pp > 1``
          (``make_pipeline_mesh``), otherwise ("data", "model") =
          (dp, tp).

        ``devices`` may also be an explicit device sequence
        (``["cuda:0", "cuda:1"]``, or one device repeated, as
        ``Session.serve(dp=, devices=)`` takes it): the port serves dp
        replicas at tp 1 in ONE process, so a plan of dp > 1 at tp 1 and
        pp 1 materialises on such a list to one ``ReplicaSlice`` a
        replica (``serve/parallel.py::replica_meshes``), the list being
        its mesh; ``Session.serve()`` puts replica r on ``devices[r]``.
        Any other plan on a device list raises ``ValueError`` (tp and pp
        run one rank process a device).

        Extra keyword arguments override Strategy fields (e.g.
        ``dtype="float32"``, ``remat=False`` for CPU smoke runs).
        """
        import torch.distributed as dist

        from repro_torch.core.strategy import Strategy

        d = self.degrees
        need = d.dp * d.pp * d.tp
        world = dist.get_world_size() if dist.is_initialized() else 1
        listed = devices is not None and not isinstance(devices, int)
        if listed:
            devs = list(devices)
            count = len(devs)
        elif devices is None:
            count = world
        else:
            if devices > world:
                raise ValueError(
                    f"plan asked for {devices} devices but only "
                    f"{world} are available")
            count = devices
        if need != count:
            raise ValueError(
                f"degrees dp{d.dp} x pp{d.pp} x tp{d.tp} = {need} chips "
                f"do not tile the {count} provided device(s); re-plan "
                f"with chips={count} or pass a matching device slice")
        if d.ep > 1 and d.tp % d.ep != 0 and d.ep % d.tp != 0:
            raise ValueError(
                f"expert-parallel degree ep{d.ep} must share the model "
                f"axis with tp{d.tp}")

        if need == 1:
            mesh = None
        elif listed:
            if d.tp > 1 or d.pp > 1:
                raise ValueError(
                    f"degrees dp{d.dp} x pp{d.pp} x tp{d.tp} on a device "
                    "list: one process serves dp replicas at tp 1 and pp "
                    "1 only; tp and pp run one rank process a device "
                    "(pass devices=None or an int under torchrun)")
            from repro_torch.serve.parallel import replica_meshes
            mesh = replica_meshes(d.dp, 1, devs)
        elif d.pp > 1:
            from repro_torch.launch.mesh import make_pipeline_mesh
            mesh = make_pipeline_mesh(data=d.dp, pipe=d.pp, model=d.tp,
                                      device_type=device_type)
        else:
            from repro_torch.launch.mesh import make_mesh
            mesh = make_mesh((d.dp, d.tp), ("data", "model"),
                             device_type=device_type)

        strategy = Strategy(
            name=f"plan/{self.method}",
            seq_parallel=d.seq_parallel,
            zero1=d.zero1,
            fsdp=d.fsdp,
            remat=d.remat,
            microbatches=d.microbatches,
        )
        if strategy_overrides:
            strategy = strategy.with_(**strategy_overrides)
        return strategy, mesh


def _divisors(n: int) -> List[int]:
    return [i for i in range(1, n + 1) if n % i == 0]


def legal_degrees(cfg: ModelConfig, shape: ShapeConfig,
                  chips: int) -> List[Degrees]:
    """Enumerate the strategy space (paper §4 'search-space' challenge:
    include every exploitable dimension, exclude illegal points)."""
    out = []
    heads = max(cfg.num_heads, cfg.ssm_heads, 1)
    for tp in _divisors(chips):
        if tp > 2 * heads:                      # no parallelism left to use
            continue
        for pp in _divisors(chips // tp):
            if pp > cfg.num_layers:
                continue
            dp = chips // (tp * pp)
            if shape.global_batch % dp != 0:
                continue
            micro_opts = sorted({1, min(shape.global_batch // dp, 4 * pp),
                                 shape.global_batch // dp})
            for m in micro_opts:
                if (shape.global_batch // dp) % m != 0:
                    continue
                for sp_flag in ((False, True) if tp > 1 else (False,)):
                    out.append(Degrees(
                        dp=dp, tp=tp, pp=pp,
                        ep=tp if cfg.is_moe else 1,
                        microbatches=m, seq_parallel=sp_flag,
                        remat=shape.kind == "train"))
    return out


def _evaluate(cfg, shape, deg, hw) -> Tuple[float, object]:
    cb = estimate(cfg, shape, deg, hw)
    penalty = 1.0 if cb.fits else 1e3           # infeasible = heavy penalty
    return cb.step_time * penalty, cb


def search_exhaustive(cfg, shape, chips: int, hw: Hardware = H100) -> Plan:
    best, best_cb, n = None, None, 0
    for deg in legal_degrees(cfg, shape, chips):
        c, cb = _evaluate(cfg, shape, deg, hw)
        n += 1
        if best is None or c < best[0]:
            best = (c, deg)
            best_cb = cb
    return Plan(degrees=best[1], cost=best_cb.step_time, mfu=best_cb.mfu,
                fits=best_cb.fits, evaluations=n, method="exhaustive",
                breakdown=best_cb)


def search_dp(cfg, shape, chips: int, hw: Hardware = H100) -> Plan:
    """Two-level: outer loop over (pp, tp); inner DP balances layers into
    stages by FLOPs from the operator graph (Alpa's hierarchy, simplified:
    our stages are homogeneous so the DP reduces to balanced cuts)."""
    graph = build_opgraph(cfg, shape.global_batch, shape.seq_len)
    best, best_cb, best_stages, n = None, None, None, 0
    for pp in _divisors(chips):
        if pp > cfg.num_layers:
            continue
        stages = graph.balanced_stages(pp) if pp > 1 else None
        for tp in _divisors(chips // pp):
            heads = max(cfg.num_heads, cfg.ssm_heads, 1)
            if tp > 2 * heads:
                continue
            dp = chips // (pp * tp)
            if shape.global_batch % dp != 0:
                continue
            m = min(shape.global_batch // dp, max(1, 4 * pp))
            while (shape.global_batch // dp) % m != 0:
                m -= 1
            deg = Degrees(dp=dp, tp=tp, pp=pp,
                          ep=tp if cfg.is_moe else 1, microbatches=m,
                          seq_parallel=tp > 1,
                          remat=shape.kind == "train")
            c, cb = _evaluate(cfg, shape, deg, hw)
            n += 1
            if best is None or c < best[0]:
                best, best_cb, best_stages = (c, deg), cb, stages
    return Plan(degrees=best[1], cost=best_cb.step_time, mfu=best_cb.mfu,
                fits=best_cb.fits, evaluations=n, method="dp",
                stage_layers=best_stages, breakdown=best_cb)


def search_mcmc(cfg, shape, chips: int, hw: Hardware = H100, *,
                iters: int = 200, temp: float = 0.05,
                seed: int = 0) -> Plan:
    """FlexFlow-style MCMC: random legal moves, accept by Metropolis."""
    rng = random.Random(seed)
    space = legal_degrees(cfg, shape, chips)
    cur = rng.choice(space)
    cur_cost, cur_cb = _evaluate(cfg, shape, cur, hw)
    best, best_cb = (cur_cost, cur), cur_cb
    n = 1
    for _ in range(iters):
        cand = rng.choice(space)
        c, cb = _evaluate(cfg, shape, cand, hw)
        n += 1
        import math
        if c < cur_cost or rng.random() < math.exp(
                (cur_cost - c) / max(temp * cur_cost, 1e-12)):
            cur, cur_cost = cand, c
        if c < best[0]:
            best, best_cb = (c, cand), cb
    return Plan(degrees=best[1], cost=best_cb.step_time, mfu=best_cb.mfu,
                fits=best_cb.fits, evaluations=n, method="mcmc",
                breakdown=best_cb)


SEARCH_METHODS = {"exhaustive": search_exhaustive, "dp": search_dp,
                  "mcmc": search_mcmc}


def plan(cfg, shape, chips: int, *, method: str = "exhaustive",
         hw: Hardware = H100) -> Plan:
    return SEARCH_METHODS[method](cfg, shape, chips, hw)
