"""Roofline terms of one rank's step, counted as it runs — the port of
``repro/launch/roofline.py``.

    compute    = FLOPs        / (chips * peak_flops)
    memory     = bytes        / (chips * hbm_bw)
    collective = ici_bytes/dev / (ici_bw * ici_links)  +  dcn_bytes/dev / dcn_bw

The reference reads FLOPs, bytes and collectives from a loop-aware parse
of XLA's compiled per-device HLO. The port runs one rank's step eagerly
(on the card, on the CPU, or on ``torch.device("meta")`` in the dry-run,
``api/session.py::Session.lower``) under :class:`Counter`, which counts
what that rank issues; the globals are the rank's values x chips, as the
reference's are the per-device values x chips.

Rates are ``core/costmodel.py::H100`` (NVIDIA's H100 SXM data sheet:
989 TFLOP/s dense bf16, 3.35 TB/s HBM3, NVLink 450 GB/s each way within a
node of 8, 50 GB/s a GPU between nodes). The terms are predictions from
those constants, not measurements.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import tp
from repro_torch.core.costmodel import H100, Hardware
from repro_torch.kernels import dispatch

aten = torch.ops.aten

#: matmul-class ops: (FLOPs of a call) from the shapes of its operands
_MM = {aten.mm.default: (0, 1), aten.addmm.default: (1, 2),
       aten.bmm.default: (0, 1), aten.baddbmm.default: (1, 2)}
#: ops that write nothing (the bytes count skips them; their storage is
#: still live memory)
_NO_DATA = {"empty", "empty_strided", "empty_like", "new_empty",
            "new_empty_strided", "detach", "alias", "lift_fresh"}


def _mm_flops(func, args) -> Optional[float]:
    packet = func.overloadpacket
    for op, (i, j) in _MM.items():
        if op.overloadpacket is packet:
            a, b = args[i].shape, args[j].shape
            return 2.0 * (a[-2] * a[-1] * b[-1]) * \
                (a[0] if len(a) == 3 else 1)
    return None


def _other_flops(func, args, kwargs, out) -> float:
    """SDPA, convolutions and the other ops of PyTorch's flop table (none
    is on the port's paths; counted as ``FlopCounterMode`` counts them)."""
    from torch.utils.flop_counter import flop_registry
    fn = flop_registry.get(func.overloadpacket)
    return 0.0 if fn is None else float(fn(*args, **kwargs, out_val=out))


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def node_local(ranks, node_size: int) -> bool:
    """Whether every rank of a group lies in one NVLink node of
    ``node_size`` under the row-major layout (rank // node_size)."""
    return len({r // node_size for r in ranks}) <= 1


class Counter(TorchDispatchMode):
    """What one rank's step issues, the same on CUDA, CPU and meta tensors:

    * ``flops`` — the matmul-class aten ops (mm, addmm, bmm, baddbmm; SDPA
      and convolutions as PyTorch's flop table counts them), forward and
      backward, as the reference's HLO parse counts dots only; plus each
      hand-written kernel's ``cost``;
    * ``bytes`` — what eager PyTorch moves: each op's tensor inputs plus
      its new outputs (an in-place or ``out=`` result, which aliases an
      input, once; views, collectives and ops that write nothing not at
      all), plus each kernel's ``cost``. Eager has no fusion, so this is
      the port's honest analogue of the reference's ``hlo_bytes``, and
      larger than a fused program's;
    * ``kernels`` — each kernel's launches (or meta stand-ins), FLOPs,
      bytes and scratch, as its wrapper charged them
      (``kernels/dispatch.py``);
    * ``collectives`` — by label, the count and bytes the rank's
      ``core/tp.py::Rank`` tallied while the counter was on, each label
      classed "ici" when its group's ranks lie in one NVLink node of
      ``hw.node_size`` (row-major), "dcn" otherwise. On an H100 cluster
      "ici" is NVLink within a node and "dcn" the network between nodes
      (InfiniBand); the record keeps the reference's key names;
    * ``peak`` — live bytes: storages the step created minus those it
      freed, at their most (storage sizes, no allocator rounding).

    ``rank`` is the Rank whose tallies to read (default: the current one
    when the counter starts)."""

    def __init__(self, rank=None, hw: Hardware = H100):
        super().__init__()
        self.rank, self.hw = rank, hw
        self.flops = 0.0
        self.bytes = 0.0
        self.kernels: Dict[str, dict] = {}
        self.collectives: Dict[str, dict] = {}
        self.live = 0
        self.peak = 0
        self._held: Dict[int, weakref.finalize] = {}
        self._before = None

    # ------------------------------------------------------------ modes
    def __enter__(self):
        if self.rank is None:
            self.rank = tp.current()
        if self.rank is not None:
            self._before = (dict(self.rank.counts), dict(self.rank.bytes))
        self._sink = dispatch.sink(self._charge)
        self._sink.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._sink.__exit__(*exc)
        for fin in self._held.values():
            fin.detach()
        self._held.clear()
        if self.rank is not None:
            counts, nbytes = self._before
            for what, n in self.rank.counts.items():
                n -= counts.get(what, 0)
                if n:
                    self._collective(what, n,
                                     self.rank.bytes[what]
                                     - nbytes.get(what, 0))
        return out

    def _collective(self, what: str, n: int, nbytes: int):
        axis = self.rank.axis_of.get(what, "model")
        ranks = self.rank.group_ranks.get(axis, ())
        kind = "ici" if node_local(ranks, self.hw.node_size) else "dcn"
        self.collectives[what] = {"count": n, "bytes": nbytes,
                                  "axis": str(axis), "kind": kind}

    def _charge(self, name, flops, nbytes, scratch):
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0,
                                           "bytes": 0.0,
                                           "scratch_bytes": 0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        k["scratch_bytes"] = max(k["scratch_bytes"], scratch)
        self.flops += flops
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if dispatch.quiet():
            return out
        if func.namespace in ("c10d", "_c10d_functional"):
            return out            # in place on its input, read from the Rank
        schema = func._schema
        fresh = self._hold(out, schema)
        if schema.name.split("::")[-1] in _NO_DATA:
            return out
        views = all(r.alias_info is not None and not r.alias_info.is_write
                    for r in schema.returns) and schema.returns
        if views:
            return out
        flops = _mm_flops(func, args)
        self.flops += flops if flops is not None else \
            _other_flops(func, args, kwargs, out)
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + \
            sum(_nbytes(t) for t in fresh)
        return out

    # --------------------------------------------------------- memory
    def _hold(self, out, schema):
        """The outputs that are new storages (no alias in the schema),
        each added to ``live`` until it is freed."""
        fresh = []
        returns = schema.returns
        outs = out if isinstance(out, (tuple, list)) and len(returns) > 1 \
            else (out,)
        for ret, o in zip(returns, outs):
            if ret.alias_info is not None:
                continue
            for t in _tensors(o):
                fresh.append(t)
                st = t.untyped_storage()
                key = id(st)
                if key in self._held:
                    continue
                n = st.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                self._held[key] = weakref.finalize(st, self._free, key, n)
        return fresh

    def _free(self, key: int, n: int):
        if self._held.pop(key, None) is not None:
            self.live -= n

    # ------------------------------------------------------------ views
    def collective_bytes(self) -> Dict[str, float]:
        """Bytes by kind, "ici" and "dcn"."""
        out = {"ici": 0.0, "dcn": 0.0}
        for c in self.collectives.values():
            out[c["kind"]] += c["bytes"]
        return out


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float             # global (= per rank x chips)
    hlo_bytes: float             # global
    coll_ici_dev: float          # bytes per rank within an NVLink node
    coll_dcn_dev: float          # bytes per rank between nodes
    model_flops: float
    coll_detail: Dict[str, float] = field(default_factory=dict)
    mem_per_device: float = 0.0
    xla_cost_analysis: Dict[str, float] = field(default_factory=dict)
    hw: Hardware = H100

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * self.hw.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def t_collective(self) -> float:
        return (self.coll_ici_dev / (self.hw.ici_bw * self.hw.ici_links)
                + self.coll_dcn_dev / self.hw.dcn_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def step_time_lower_bound(self) -> float:
        """max of the three terms = perfectly-overlapped step time."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def mfu_upper_bound(self) -> float:
        t = self.step_time_lower_bound
        if t == 0:
            return 0.0
        return self.model_flops / (self.chips * self.hw.peak_flops * t)

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "coll_ici_bytes_per_dev": self.coll_ici_dev,
            "coll_dcn_bytes_per_dev": self.coll_dcn_dev,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "mfu_upper_bound": self.mfu_upper_bound,
            "mem_per_device_gb": self.mem_per_device / 1e9,
            "coll_detail": self.coll_detail,
            "xla_cost_analysis": self.xla_cost_analysis,
        }


def model_flops_train(cfg, tokens: int) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) — the MFU numerator (paper §6)."""
    return 6.0 * cfg.active_param_count() * tokens


def model_flops_decode(cfg, tokens: int) -> float:
    return 2.0 * cfg.active_param_count() * tokens


def extract(counter: Counter, *, arch: str, shape: str, mesh_name: str,
            chips: int, model_flops: float, mem_per_device: float = 0.0,
            hw: Hardware = H100) -> Roofline:
    """The roofline of one rank's counted step (the reference's
    ``extract(compiled, ...)``): globals are the rank's counts x chips;
    ``coll_detail`` holds each label's bytes; ``xla_cost_analysis`` is
    empty (there is no XLA)."""
    coll = counter.collective_bytes()
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=counter.flops * chips, hlo_bytes=counter.bytes * chips,
        coll_ici_dev=coll["ici"], coll_dcn_dev=coll["dcn"],
        model_flops=model_flops,
        coll_detail={k: float(v["bytes"])
                     for k, v in counter.collectives.items()},
        mem_per_device=mem_per_device, hw=hw)
