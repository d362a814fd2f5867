"""Data-parallel replica routing over serving engines — the port of
``repro/serve/parallel.py``.

The survey's parallel-serving decomposition (Nagrecha 2023) splits a
model server along two axes: tensor parallelism shards one replica's
operators over ``tp`` ranks (``ServeEngine(mesh=)``, serve/engine.py),
and data parallelism replicates whole engines ``dp`` times and balances
requests between them. This module is the second half:

* :func:`replica_meshes` — ``dp`` disjoint slices of ``tp`` devices, one
  a replica (the reference's ("data", "model") = (1, tp) sub-meshes);
* :class:`ReplicaRouter` — one engine a replica behind one
  ``submit`` / ``run`` / ``stats`` facade, routing by the reference's
  rules: LEAST LOAD (queued + active requests, the lowest index on ties)
  until every replica has a decoded-tokens/s EWMA
  (``stats["tokens_per_s_ewma"]``), then LATENCY-AWARE ``load / rate``
  (the estimated time to drain the replica's backlog); PREFIX AFFINITY on
  top when the engines run a prefix cache: a prompt whose page-aligned
  first block was routed before goes to the same replica, unless that
  replica is more than ``slots`` requests behind the least loaded one.

Two layouts, chosen by ``tp``:

* **one process** (``tp == 1``): the router holds all ``dp`` engines,
  engine ``r`` on ``devices[r]`` (default: the visible devices of the
  params' device type; more replicas than devices raise the reference's
  ``"devices needed"`` ``ValueError``). A list may repeat a device to put
  several replicas on it: ``.to()`` onto the device a tensor already
  occupies copies nothing, so such replicas share one read-only set of
  weights, each with its own KV pool. ``step`` advances every busy
  replica in turn from this one thread; the online driver
  (serve/driver.py) takes this router as it takes an engine.
* **one process a rank** (``tp > 1``, ``world = dp * tp`` ranks, as
  ``torchrun`` starts them): a ``DeviceMesh`` ("data", "model") = (dp,
  tp), or ("pod", "data", "model") with pods x data = dp rows, pod
  major; each process builds the engine of its row, whose collectives run
  on the row's "model" group and whose root is the row's first rank.
  Every process runs this router on the same submissions. ``route``
  reads one table of ``(load, rate)`` for every replica, summed by one
  world all-reduce to which only each row's "model"-rank 0 contributes —
  so every process of every row reads the same numbers and routes alike
  (each rank's own clock would otherwise make the rates differ between
  the ranks of a row). A request goes into its replica's engine only
  (every process checks it with ``check_request``, so a refusal raises
  everywhere). ``run`` steps the local engine while any replica is busy
  (one world MAX all-reduce a round) and returns the union of every
  replica's records on every process: each row's root broadcasts its
  records (rid, done, expired, tokens) as one padded int tensor.
  ``stats``, ``results`` and ``release_prefix_cache`` are collectives
  there too: every process calls them. The router's collectives are
  tallied in the local engine's ``rank.counts`` under ``router_table``,
  ``router_busy``, ``router_results``, ``router_stats`` and
  ``router_layout``. The online driver (serve/driver.py) serves this
  layout from global rank 0: it broadcasts the submissions to the world
  before each step, and each other row's root returns its requests' new
  tokens to rank 0.

``Session.serve(dp=, tp=)`` and ``launch/serve.py --dp/--tp`` build the
router; it is usable with hand-built device lists as well.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.strategy import mesh_axes
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.tracing import chrome_trace, export_chrome_trace
from repro_torch.tree import flatten, tree_map


@dataclass(frozen=True)
class ReplicaSlice:
    """One replica's ``tp`` devices: the reference's (1, tp) sub-mesh."""
    devices: Tuple[torch.device, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": 1, "model": len(self.devices)}


def visible_devices(device_type: str) -> List[torch.device]:
    """The devices of ``device_type`` this process sees: every CUDA card,
    or the one CPU device."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def replica_meshes(dp: int, tp: int, devices: Optional[Sequence] = None, *,
                   device_type: str = "cuda") -> List[ReplicaSlice]:
    """``dp`` slices of ``tp`` devices over the first ``dp * tp`` of
    ``devices`` (default: the visible devices of ``device_type``)."""
    if dp < 1 or tp < 1:
        raise ValueError(f"dp and tp must be >= 1, got dp{dp} tp{tp}")
    devs = [torch.device(d) for d in (
        devices if devices is not None else visible_devices(device_type))]
    if dp * tp > len(devs):
        raise ValueError(
            f"dp{dp} x tp{tp} = {dp * tp} devices needed but only "
            f"{len(devs)} available (a device list may repeat a device to "
            "put several replicas on it)")
    return [ReplicaSlice(tuple(devs[r * tp:(r + 1) * tp]))
            for r in range(dp)]


class ReplicaRouter:
    """``dp`` ServeEngine replicas behind one submit/run/stats facade (see
    the module docstring for the two layouts).

    Every engine keyword (slots, max_len, paged, page_size, prefix_cache,
    lazy, scheduler, spec, ...) applies to each replica. ``scheduler``
    may be one shared object only where the policy keeps no state (the
    shipped policies keep none). ``mesh`` is a ("data", "model") = (dp,
    tp) ``DeviceMesh``, or a ("pod", "data", "model") one with pods x data
    = dp; None builds the first over the default process group on the
    params' device type (at tp > 1 only)."""

    def __init__(self, cfg, params, *, dp: int, tp: int = 1,
                 devices: Optional[Sequence] = None, strategy=None,
                 mesh=None, **engine_kw):
        self.dp, self.tp = int(dp), int(tp)
        self.cfg = cfg
        device_type = next(iter(flatten(params).values())).device.type
        self.mesh = None
        if self.tp == 1 and mesh is None:
            self.meshes = replica_meshes(self.dp, 1, devices,
                                         device_type=device_type)
            self.engines: List[ServeEngine] = [
                ServeEngine(cfg, tree_map(lambda t, d=m.devices[0]: t.to(d),
                                          params),
                            device=m.devices[0], strategy=strategy,
                            **engine_kw)
                for m in self.meshes]
            self.row = None
        else:
            if devices is not None:
                raise ValueError(
                    "devices= places replicas in one process; at tp > 1 "
                    "each rank process serves on its own device")
            if mesh is None:
                from repro_torch.launch.mesh import make_mesh
                mesh = make_mesh((self.dp, self.tp), ("data", "model"),
                                 device_type=device_type)
            axes = mesh_axes(mesh)
            rows = axes.get("pod", 1) * axes.get("data", 1)
            if set(axes) not in ({"data", "model"},
                                 {"pod", "data", "model"}) or \
                    axes["model"] != self.tp or rows != self.dp:
                raise ValueError(
                    f"a dp{self.dp} x tp{self.tp} router needs a ('data', "
                    f"'model') = ({self.dp}, {self.tp}) mesh, or a ('pod', "
                    f"'data', 'model') one of pods x data = {self.dp}, got "
                    f"{axes}")
            self.mesh = mesh
            self.engines = [ServeEngine(cfg, params, mesh=mesh,
                                        strategy=strategy, **engine_kw)]
            # the row: this rank's ("pod", "data") coordinate, pod major
            self.row = self._local._rank.batch_rank
            self.meshes = self._rank_rows()
        # each replica's tracer carries its index: a merged Chrome export
        # gets one process lane a replica
        for r, e in zip(self._replicas(), self.engines):
            e.tracer.replica = r
        self._home: Dict[int, int] = {}      # rid -> replica index
        self._affine: Dict[Tuple, int] = {}  # first-block key -> replica
        # rid -> (prompt, max_new): the records of other rows' requests
        self._subs: Dict[int, Tuple[np.ndarray, int]] = {}

    # ------------------------------------------------------- collectives
    def _replicas(self) -> List[int]:
        """The replica indices of ``self.engines``."""
        return list(range(self.dp)) if self.mesh is None else [self.row]

    @property
    def _local(self) -> ServeEngine:
        return self.engines[0]

    def _lead(self) -> bool:
        """Whether this process speaks for its row (its "model" rank 0)."""
        return self._local._rank.rank == 0

    def _world_sum(self, t: torch.Tensor, what: str, op=None):
        self._local._rank.counts[what] += 1
        dist.all_reduce(t, op=op or dist.ReduceOp.SUM)
        return t

    def _rank_rows(self) -> List[Tuple[int, ...]]:
        """The global ranks of each row (replica), from one all-reduce of
        a (dp, tp) table where each process writes its own rank."""
        t = torch.zeros((self.dp, self.tp), dtype=torch.int64,
                        device=self._local.device)
        t[self.row, self._local._rank.rank] = dist.get_rank()
        self._world_sum(t, "router_layout")
        return [tuple(int(x) for x in row) for row in t.cpu().tolist()]

    def _table(self) -> Tuple[List[int], List[float]]:
        """(load, rate) of every replica: read off the engines in one
        process; summed over the world from each row's lead otherwise."""
        if self.mesh is None:
            return ([self._load(e) for e in self.engines],
                    [self._rate(e) for e in self.engines])
        t = torch.zeros((self.dp, 2), dtype=torch.float64,
                        device=self._local.device)
        if self._lead():
            t[self.row, 0] = self._load(self._local)
            t[self.row, 1] = self._rate(self._local)
        rows = self._world_sum(t, "router_table").cpu().tolist()
        return [int(a) for a, _ in rows], [float(b) for _, b in rows]

    # ----------------------------------------------------------- routing
    @staticmethod
    def _load(e: ServeEngine) -> int:
        return len(e.queue) + sum(a is not None for a in e.active)

    @staticmethod
    def _rate(e: ServeEngine) -> float:
        """The engine's decoded-tokens/s EWMA — 0.0 until it has decoded
        anything."""
        return float(e.stats["tokens_per_s_ewma"])

    def _affinity_key(self, prompt: np.ndarray) -> Optional[Tuple]:
        """The prompt's page-aligned first block (the unit the prefix
        cache shares) as the routing key; None without a prefix cache or
        a full first block."""
        e = self._local
        if e._prefix is None or len(prompt) < e.page_size:
            return None
        return tuple(int(t) for t in prompt[:e.page_size])

    def route(self, prompt) -> int:
        """Replica index for ``prompt``: latency-aware ``load / rate`` once
        every replica has a rate, else the least load (lowest index on
        ties); the replica that first took the prompt's first block wins
        while its load is within ``slots`` of the chosen one's. Changes
        nothing (a world all-reduce under tp > 1: every process calls
        it)."""
        loads, rates = self._table()
        if all(rate > 0.0 for rate in rates):
            best = min(range(self.dp),
                       key=lambda r: (loads[r] / rates[r], loads[r], r))
        else:
            best = min(range(self.dp), key=lambda r: (loads[r], r))
        key = self._affinity_key(np.asarray(prompt).reshape(-1))
        if key is not None:
            aff = self._affine.get(key)
            if aff is not None and \
                    loads[aff] <= loads[best] + self._local.slots:
                return aff
        return best

    def submit(self, rid: int, prompt, max_new: int, *, frames=None,
               images=None, priority: int = 0,
               deadline_s: Optional[float] = None) -> int:
        """Route and enqueue one request; returns the replica index it
        landed on. A request no replica could serve raises the engine's
        ``ValueError`` before any state changes."""
        if rid in self._home:
            raise ValueError(f"request {rid} was already submitted "
                             f"(to replica {self._home[rid]})")
        prompt = self._local.check_request(
            rid, prompt, max_new, frames=frames, images=images,
            deadline_s=deadline_s)[0]
        r = self.route(prompt)
        if r in self._replicas():
            self.engines[self._replicas().index(r)].submit(
                rid, prompt, max_new, frames=frames, images=images,
                priority=priority, deadline_s=deadline_s)
        self._home[rid] = r
        if self.mesh is not None:
            self._subs[rid] = (prompt, int(max_new))
        key = self._affinity_key(prompt)
        if key is not None and key not in self._affine:
            self._affine[key] = r
        return r

    # ----------------------------------------------------------- serving
    def busy(self) -> bool:
        """Whether any replica has a request queued or in a slot (a world
        all-reduce under tp > 1)."""
        busy = any(e.busy() for e in self.engines)
        if self.mesh is None:
            return busy
        t = torch.tensor([int(busy)], dtype=torch.int64,
                         device=self._local.device)
        return bool(self._world_sum(t, "router_busy",
                                    dist.ReduceOp.MAX).item())

    def step(self):
        """Advance every busy local replica by one engine step (idle ones
        skip the device)."""
        for e in self.engines:
            if e.busy():
                e.step()

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        """Step every replica until all drain (or ``max_steps`` rounds);
        returns the union of every replica's records — completed, partial
        and queued."""
        steps = 0
        while steps < max_steps and self.busy():
            self.step()
            steps += 1
        return self.results()

    def results(self) -> Dict[int, Request]:
        """Every replica's request records; under tp > 1 each row's root
        broadcasts its replica's (a collective), and another row's
        requests come back as new records."""
        out: Dict[int, Request] = {}
        for e in self.engines:
            out.update(e.results())
        if self.mesh is None:
            return out
        mine = dict(out)
        for r, ranks in enumerate(self.meshes):
            flat = self._broadcast_records(mine if r == self.row else None,
                                           ranks[0])
            if r == self.row:
                continue
            i = 0
            while i < len(flat):
                rid, done, expired, n = (int(x) for x in flat[i:i + 4])
                prompt, max_new = self._subs[rid]
                out[rid] = Request(rid, prompt, max_new,
                                   out=[int(x) for x in flat[i + 4:i + 4 + n]],
                                   done=bool(done), expired=bool(expired))
                i += 4 + n
        return out

    def _broadcast_records(self, records, src: int) -> List[int]:
        """``records`` of row root ``src`` as a flat int list on every
        process: one broadcast of its length, one of the padded tensor."""
        dev = self._local.device
        flat: List[int] = []
        if records is not None and dist.get_rank() == src:
            for rid in sorted(records):
                req = records[rid]
                flat += [rid, int(req.done), int(req.expired),
                         len(req.out), *req.out]
        n = torch.tensor([len(flat)], dtype=torch.int64, device=dev)
        counts = self._local._rank.counts
        counts["router_results"] += 2
        dist.broadcast(n, src=src)
        buf = torch.zeros((max(int(n.item()), 1),), dtype=torch.int64,
                          device=dev)
        if flat:
            buf[:len(flat)] = torch.tensor(flat, dtype=torch.int64)
        dist.broadcast(buf, src=src)
        return buf[:int(n.item())].cpu().tolist()

    def release_prefix_cache(self) -> int:
        """Pages every replica's prefix cache gave back (a world
        all-reduce under tp > 1)."""
        freed = sum(e.release_prefix_cache() for e in self.engines)
        if self.mesh is None:
            return freed
        t = torch.tensor([freed if self._lead() else 0], dtype=torch.int64,
                         device=self._local.device)
        return int(self._world_sum(t, "router_release").item())

    # ------------------------------------------------------------- stats
    def _replica_stats(self) -> List[Dict]:
        """Every replica's stats dict: the engines' own in one process;
        under tp > 1 the numbers of each row's lead, summed over the world
        (every process calls it)."""
        per = [dict(e.stats) for e in self.engines]
        if self.mesh is None:
            return per
        mine = per[0]
        keys = [k for k, v in mine.items()
                if not isinstance(v, bool) and isinstance(v, (int, float))]
        t = torch.zeros((self.dp, len(keys)), dtype=torch.float64,
                        device=self._local.device)
        if self._lead():
            t[self.row] = torch.tensor([float(mine[k]) for k in keys],
                                       dtype=torch.float64)
        rows = self._world_sum(t, "router_stats").cpu().tolist()
        out = []
        for row in rows:
            d = dict(mine)
            d.update({k: type(mine[k])(v) for k, v in zip(keys, row)})
            out.append(d)
        return out

    @property
    def stats(self) -> Dict:
        """Counter sums across replicas, the identity fields
        (``decode_backend``) of replica 0, and ``replicas``: the
        per-replica dicts (program-shape counts are per replica: one each
        reads as 1 in every entry). Replicas are disjoint engines, so
        ``step_count`` / ``decode_tokens`` / ``wall_time_s`` sum to fleet
        totals (wall time is engine-step seconds, not elapsed time) and
        ``tokens_per_s_ewma`` sums to the fleet's decode rate."""
        per = self._replica_stats()
        agg: Dict = {}
        for k, v in per[0].items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                agg[k] = v
            else:
                agg[k] = sum(p[k] for p in per)
        agg["replicas"] = per
        return agg

    def reset_stats(self):
        """Reset every local replica's counters (program-shape counts
        stay; ServeEngine.reset_stats)."""
        for e in self.engines:
            e.reset_stats()

    def replica_of(self, rid: int) -> Optional[int]:
        return self._home.get(rid)

    def kv_bytes(self) -> int:
        """Global resident decode-state bytes of all replicas (under tp > 1
        the local replica's times dp: the replicas are alike)."""
        total = sum(e.kv_bytes() for e in self.engines)
        return total if self.mesh is None else total * self.dp

    def per_device_kv_bytes(self) -> int:
        """Resident decode-state bytes of one replica on one device (the
        largest over the local replicas)."""
        return max(e.per_device_kv_bytes() for e in self.engines)

    # ----------------------------------------------------- observability
    @property
    def tracers(self) -> List:
        """The local replicas' tracers, each stamped with its replica."""
        return [e.tracer for e in self.engines]

    def trace(self) -> Dict:
        """ONE merged Chrome ``trace_event`` object: replica ``r`` is
        process lane ``r`` (under tp > 1 this process's replica only)."""
        return chrome_trace(self.tracers)

    def export_trace(self, path: str) -> Dict:
        """Write the merged Chrome/Perfetto trace JSON to ``path``."""
        return export_chrome_trace(path, self.tracers)

    def flight(self, last: Optional[int] = None) -> Dict:
        """The local replicas' flight-recorder snapshots, one dict."""
        return {"replicas": [t.flight(last) for t in self.tracers]}
