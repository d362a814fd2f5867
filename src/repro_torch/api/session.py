"""Session — the port's execution facade (the train and serve halves of
``repro/api/session.py``).

    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.train.trainer import TrainConfig

    session = Session(get_config("qwen3-14b"))          # on "cuda"
    engine = session.serve(slots=4, max_len=1024, chunk_tokens=256)
    engine.submit(0, prompt, max_new=16)
    results = engine.run()

    small = Session(get_config("qwen3-14b").with_(num_layers=4))
    small.train(TrainConfig(steps=6), global_batch=1, seq_len=4096).run()

    ssm = Session(get_config("mamba2-780m")).serve(slots=4, max_len=2048)
    moe = Session(get_config("olmoe-1b-7b")).serve(slots=4, max_len=1024)
    Session(get_config("zamba2-1.2b")).train(global_batch=1, seq_len=4096)
    audio = Session(get_config("whisper-tiny")).serve(slots=8, max_len=448)
    audio.submit(0, prompt, max_new=64, frames=frames)  # (1500, 384)
    vlm = Session(get_config("llama-3.2-vision-90b").with_(num_layers=20))
    vlm.serve(slots=4, max_len=1024).submit(0, prompt, max_new=16,
                                            images=images)  # (1601, 8192)

    tokens = session.generate(prompt_batch, steps=16)   # (B, 16) greedy

    # the planner's choice, executed (core/planner.py; H100 by default)
    from repro_torch.api import plan
    from repro_torch.configs import SHAPES
    p = plan(cfg, SHAPES["train_4k"], chips=1)
    session = Session.from_plan(cfg, p)          # plan -> (Strategy, mesh)
    session.train(TrainConfig(steps=6), global_batch=1, seq_len=4096)
    # in each of 4 rank processes: the plan's dp x tp (x pp) mesh
    session = Session.from_plan(cfg, plan(cfg, shape, 4, method="dp"))
    session.train(...); session.serve(slots=4)   # the plan's degrees

    # tensor-parallel, in each of 2 rank processes (torchrun)
    engine = Session(get_config("qwen3-14b")).serve(tp=2, slots=4)
    # two data-parallel replicas in one process, here on one card
    router = session.serve(dp=2, devices=["cuda:0"] * 2, slots=4)
    # dp 2 x tp 2, in each of 4 rank processes (torchrun)
    router = Session(get_config("qwen3-14b")).serve(dp=2, tp=2, slots=4)
    # sharded training, dp 2 x tp 2, in each of 4 rank processes
    small.train(TrainConfig(steps=3), global_batch=2, seq_len=2048,
                tp=2, dp=2).run()

One object owns the config, the strategy, the device and the params
(random from ``seed`` unless given — e.g. from the JAX package's
checkpoint through ``repro_torch.params.load_npz``). ``train`` trains
those params in place, so a later ``serve`` sees the trained weights.
``serve`` takes the reference's keyword names and the reference's family
and layout rules: a full-attention dense or MoE decoder gets the paged
mixed-step engine by default (``mixed=False``: the split prefill/decode
path on the pool; ``paged=False``: the dense per-slot layout), a
sliding-window config the dense ring, the SSM family and the hybrid the
split path on the dense layout; ``prefix_cache``, ``lazy`` and
``scheduler`` pass through to the engine (on the paged pool); ``tp=N``
serves any family tensor-parallel, one engine a rank process; ``dp=M``
serves M replicas behind a ``ReplicaRouter`` (serve/parallel.py).
``train(tp=, dp=)`` trains any family on a ("data", "model") mesh, one
trainer a rank process, with the strategy's ZeRO-1, FSDP and sequence
parallelism, and an MoE's experts or (``expert_parallel=False``) each
expert's d_ff over "model".
``generate`` is the lockstep greedy loop
(``serve/step.py::greedy_generate``). ``serve_async`` wraps the engine
in the online ``AsyncDriver`` (a background step loop, per-request token
streams, TTFT/TPOT metrics, a watchdog) and ``serve_http`` puts the
stdlib HTTP front-end over that (serve/server.py). ``save`` /
``restore`` write and read the npz checkpoints both packages read
(checkpoint/io.py). The enc-dec audio family serves (frames with each
request), generates from a batch dict with ``frames`` and trains on a
``data=`` object whose batches carry frames; the VLM likewise with
``images`` (requests) and ``image_embeds`` (batches), on the split path
over the dense layout only. ``from_plan`` materialises a planner ``Plan``
(``core/planner.py``) and keeps it: ``train`` and ``serve`` then default
to its degrees on its mesh. The features not ported yet raise
``NotImplementedError`` naming their ROADMAP.md item. ``dryrun`` and
``lower`` trace one rank's step on ``torch.device("meta")`` over a fake
process group of the mesh's ranks and report the reference's record:
memory and the roofline terms (``launch/{specs,roofline,dryrun}.py``).

    rec = Session(get_config("qwen3-14b"),
                  mesh={"data": 16, "model": 16}).dryrun("train_4k")

    driver = session.serve_async(slots=4, max_len=1024)
    stream = driver.submit(prompt, max_new=16)      # tokens as they come
    server = session.serve_http(port=0, slots=4)    # POST /generate ...
    # online at tp 2, in each of 2 rank processes: rank 0 binds the port
    server = Session(get_config("qwen3-14b")).serve_http(tp=2, port=8000)
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import (latest_step, load_checkpoint,
                                       save_checkpoint)
from repro_torch.core.strategy import Strategy, mesh_axes, serving
from repro_torch.launch.mesh import make_mesh
from repro_torch.params import init_params
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.step import greedy_generate
from repro_torch.train.trainer import (TrainConfig, Trainer,
                                       check_kernel_limits)
from repro_torch.tree import tree_map


class Lowered(NamedTuple):
    """What :meth:`Session.lower` traced: the step callable, the rank's
    meta arguments (``launch/specs.py``), their specs, and the counter
    that held its counts (``launch/roofline.py::Counter``)."""
    step: object
    args: tuple
    specs: tuple
    counter: object


class Session:
    """One (config, strategy, device, params) quadruple, and the mesh and
    plan of :meth:`from_plan`."""

    def __init__(self, cfg, *, strategy: Optional[Strategy] = None,
                 device="cuda", seed: int = 0, params=None, mesh=None):
        self.cfg = cfg
        self.strategy = strategy if strategy is not None else \
            Strategy(dtype=cfg.dtype)
        self.device = torch.device(device)
        self.seed = seed
        self.mesh = mesh
        self.plan = None                    # set by from_plan
        self._params = params

    @property
    def params(self):
        """The param tree, random-initialised on first use from the
        session's seed; a trainer trains (and restores) it in place."""
        if self._params is None:
            self._params = init_params(self.cfg, device=self.device,
                                       seed=self.seed)
        return self._params

    @params.setter
    def params(self, value):
        self._params = value

    @classmethod
    def from_plan(cls, cfg, plan, *, devices=None, seed: int = 0,
                  device="cuda", **strategy_overrides) -> "Session":
        """Materialise a planner ``Plan`` (``Plan.materialize``: the
        plan's degrees over the ranks of the initialised process group,
        none needed for one device) and build the Session on it — the
        search-to-execution hand-off. Strategy-field overrides
        (``dtype="float32"``, ``remat=False``, ...) pass through. The
        plan, its strategy and its mesh are kept on the session, so a
        later :meth:`train` or :meth:`serve` without ``tp=`` / ``dp=``
        runs at ITS degrees on that mesh."""
        strategy, mesh = plan.materialize(
            devices=devices, device_type=torch.device(device).type,
            **strategy_overrides)
        session = cls(cfg, strategy=strategy, device=device, seed=seed,
                      mesh=mesh)
        session.plan = plan
        return session

    def dryrun(self, shape, *, verbose: bool = False,
               arch: Optional[str] = None, mesh_name: Optional[str] = None,
               rank: int = 0) -> dict:
        """Trace the step for ``shape`` (a ``SHAPES`` name or a
        ``ShapeConfig``) as one rank of this session's mesh WITHOUT
        allocating params, and report memory and roofline — the what-if
        check behind ``launch/dryrun.py`` (:meth:`lower`)."""
        rec, _ = self.lower(shape, verbose=verbose, arch=arch,
                            mesh_name=mesh_name, rank=rank)
        return rec

    def lower(self, shape, *, verbose: bool = False,
              arch: Optional[str] = None, mesh_name: Optional[str] = None,
              rank: int = 0):
        """Like :meth:`dryrun` but also returns the :class:`Lowered` step:
        the callable and the rank's meta arguments it was traced on.

        The reference jit-lowers the GSPMD program and compiles it. The
        port runs ``rank``'s step eagerly on ``torch.device("meta")``
        tensors (``launch/specs.py``: the rank's parameter blocks,
        optimizer state, batch rows and cache), in one process, under
        ``launch/roofline.py::Counter``. The mesh is the session's: None
        (one chip) or a mapping such as ``{"data": 16, "model": 16}``
        (``"pod"`` too), laid over a fake process group of that many
        ranks made here and destroyed before this returns, errors
        included (``launch/mesh.py::fake_mesh``; ``ValueError`` when a
        process group is already initialised). The kernels' wrappers take
        the branch of the session's device (``kernels/dispatch.py``):
        for "cuda" the kernels' checks and allocations, each charging its
        ``cost``; for "cpu" the plain versions. Training traces
        ``train/step.py::make_train_step`` on the session's strategy;
        prefill and decode ``serve/step.py``'s steps on the layout an
        engine serves (``core/strategy.py::serving``).

        The record has the reference's keys; ``compile_s`` is the trace's
        seconds and ``memory_analysis`` counts the rank: arguments (its
        params, optimizer state, batch rows, cache), outputs (the tensors
        returned), temp (the most bytes the step held above the
        arguments), code 0, alias (params and optimizer state in training,
        the cache in decode: the port updates them in place)."""
        import math
        import time
        from contextlib import nullcontext

        from repro_torch.configs import SHAPES
        from repro_torch.core import tp
        from repro_torch.data.pipeline import rows_split
        from repro_torch.kernels import dispatch
        from repro_torch.launch import roofline as rl
        from repro_torch.launch import specs as sp
        from repro_torch.launch.mesh import fake_mesh
        from repro_torch.params import full_shapes
        from repro_torch.serve.step import make_decode_step, make_prefill_step
        from repro_torch.train.step import make_train_step

        shape = SHAPES[shape] if isinstance(shape, str) else shape
        cfg = self.cfg
        axes = {} if self.mesh is None else mesh_axes(self.mesh)
        chips = math.prod(axes.values()) if axes else 1
        arch = arch or cfg.name
        mesh_name = mesh_name or ("x".join(f"{n}{a}" for a, n in
                                           axes.items()) or "1chip")
        train = shape.kind == "train"
        strategy = self.strategy if train else serving(self.strategy)
        t0 = time.perf_counter()
        with (fake_mesh(axes, rank) if chips > 1 else nullcontext()) as dm, \
                dispatch.as_device(self.device.type):
            r = None if dm is None else tp.Rank.of(
                dm, cfg, strategy, full_shapes(cfg) if train else None)
            mesh = axes or None
            with tp.active(r), torch.no_grad() if not train else \
                    nullcontext():
                if train:
                    check_kernel_limits(cfg, strategy, self.device, r)
                    step = make_train_step(cfg, strategy)
                    args, specs = sp.train_specs(cfg, shape, mesh, strategy)
                    dp = r.batch_dp if r is not None else 1
                    keep = shape.global_batch // dp if rows_split(
                        shape.global_batch, dp, strategy.microbatches) \
                        else shape.global_batch
                    rows = {k: v[:keep] for k, v in args[2].items()}
                    arg_bytes = sp.tensor_bytes(args[0], args[1]) + sum(
                        v.numel() * v.element_size() for v in rows.values())
                    alias = sp.tensor_bytes(args[0], args[1])
                    mf = rl.model_flops_train(
                        cfg, shape.global_batch * shape.seq_len)
                elif shape.kind == "prefill":
                    step = make_prefill_step(cfg, strategy)
                    args, specs = sp.prefill_specs(cfg, shape, mesh,
                                                   strategy)
                    arg_bytes, alias = sp.tensor_bytes(*args), 0
                    mf = rl.model_flops_decode(
                        cfg, shape.global_batch * shape.seq_len)
                else:                 # decode: ONE token against the cache
                    step = make_decode_step(cfg, strategy)
                    args, specs = sp.decode_specs(cfg, shape, mesh, strategy)
                    arg_bytes = sp.tensor_bytes(*args)
                    alias = sp.tensor_bytes(args[1])
                    mf = rl.model_flops_decode(cfg, shape.global_batch)
                counter = rl.Counter(r)
                with counter:
                    out = step(*args)
                out_bytes = sp.tensor_bytes(out)
        trace_s = time.perf_counter() - t0
        mem = {"argument_size_in_bytes": arg_bytes,
               "output_size_in_bytes": out_bytes,
               "temp_size_in_bytes": counter.peak,
               "generated_code_size_in_bytes": 0,
               "alias_size_in_bytes": alias}
        roof = rl.extract(counter, arch=arch, shape=shape.name,
                          mesh_name=mesh_name, chips=chips, model_flops=mf,
                          mem_per_device=arg_bytes + counter.peak)
        rec = {
            "arch": arch, "shape": shape.name, "mesh": mesh_name,
            "status": "ok", "strategy": strategy.name,
            "strategy_detail": {
                "seq_parallel": strategy.seq_parallel,
                "fsdp": strategy.fsdp,
                "optimizer": strategy.optimizer,
                "microbatches": strategy.microbatches,
                "remat": strategy.remat, "attn_impl": strategy.attn_impl},
            "compile_s": round(trace_s, 3),
            "memory_analysis": mem,
            "roofline": roof.row(),
            "device": self.device.type, "rank": rank,
            "kernels": counter.kernels,
            "collectives": counter.collectives,
        }
        if strategy != self.strategy:
            rec["note"] = ("served on core/strategy.py::serving's layout "
                           f"(seq_parallel {self.strategy.seq_parallel}, "
                           f"fsdp {self.strategy.fsdp} off)")
        if verbose:
            row = roof.row()
            print(f"[{arch} x {shape.name} x {mesh_name}] trace "
                  f"{rec['compile_s']}s  bottleneck={row['bottleneck']} "
                  f"t_comp={row['t_compute_s']:.3e} "
                  f"t_mem={row['t_memory_s']:.3e} "
                  f"t_coll={row['t_collective_s']:.3e} "
                  f"useful={row['useful_ratio']:.2f} "
                  f"mem/dev={row['mem_per_device_gb']:.2f}GB", flush=True)
        return rec, Lowered(step, args, specs, counter)

    def _rank_mesh(self, dp: int, tp: int, pp: int = 1):
        """The session's own ``DeviceMesh`` where it is the (dp, tp) or
        (dp, pp, tp) layout asked for (the ``from_plan`` case), else
        None."""
        if self.mesh is None or isinstance(self.mesh, (list, tuple)):
            return None
        want = {"data": dp, "pipe": pp, "model": tp} if pp > 1 else \
            {"data": dp, "model": tp}
        return self.mesh if mesh_axes(self.mesh) == want else None

    def restore(self, checkpoint_dir: str) -> Optional[int]:
        """Load the latest checkpoint under ``checkpoint_dir`` into the
        session (None if there is none). Returns the restored step."""
        last = latest_step(checkpoint_dir)
        if last is not None:
            self._params = load_checkpoint(checkpoint_dir, last,
                                           self.params)
        return last

    def save(self, checkpoint_dir: str, step: int = 0):
        """Write the session's params as checkpoint ``step`` under
        ``checkpoint_dir``; returns the step's directory."""
        return save_checkpoint(checkpoint_dir, step, self.params)

    def train(self, train_cfg: Optional[TrainConfig] = None, *, data=None,
              global_batch: int = 8, seq_len: int = 256,
              restore: bool = False, tp: Optional[int] = None,
              dp: Optional[int] = None) -> Trainer:
        """A Trainer on this session's strategy, device and params (the
        session's seed initialises them). ``restore=True`` resumes from
        the TrainConfig's checkpoint dir first. The enc-dec family trains
        on a ``data=`` object whose ``batch(step)`` carries ``frames``
        beside the tokens, the VLM on one that carries ``image_embeds``:
        the default token dataset has neither, so its first step raises
        ``KeyError`` in the model's forward, where the reference's fails
        too.

        ``tp=N`` and / or ``dp=M`` (with N x M > 1), called on every rank
        of an initialised process group of M x N ranks (one process a
        rank, as ``torchrun`` starts them), train a dense or MoE decoder,
        the SSM family, the hybrid or the enc-dec family (on the same
        ``data=`` object on every rank: each rank takes its rows of the
        global batch, frames with their tokens) as this rank of the
        ("data", "model") = (M, N) mesh on the
        session's device type (``train/trainer.py``): the session's
        params cut to the rank's blocks, or, when the session has none
        yet, only the rank's blocks drawn from its seed (kept by the
        trainer: the session's ``params`` stay the full tree, or none).

        Without ``tp=`` / ``dp=`` a session built by :meth:`from_plan`
        trains at its plan's degrees on its mesh: a ("data", "model")
        mesh as above, or the ("data", "pipe", "model") mesh of a plan
        with pp > 1, where each "pipe" slice holds whole replicas and
        takes the same step (the reference's Trainer never runs
        ``core/pipeline.py`` either). A plan of dp > 1 materialised on a
        device list (one process) has no ranks to train on: ValueError."""
        tc = train_cfg or TrainConfig(seed=self.seed)
        mesh = None
        if tp is None and dp is None and self.plan is not None and \
                self.mesh is not None:
            d = self.plan.degrees
            mesh = self._rank_mesh(d.dp, d.tp, d.pp)
            if mesh is None:
                raise ValueError(
                    f"plan[{self.plan.method}] "
                    f"{self.plan.summary(compact=True)} was materialised "
                    "on a device list, which serves dp replicas in one "
                    "process; training it needs a process group of "
                    f"{d.dp * d.tp * d.pp} ranks (torchrun)")
        tp, dp = tp or 1, dp or 1
        if mesh is None and tp * dp > 1:
            mesh = make_mesh((dp, tp), ("data", "model"),
                             device_type=self.device.type)
        if mesh is not None:
            trainer = Trainer(self.cfg, self.strategy, self.device, tc,
                              data=data, global_batch=global_batch,
                              seq_len=seq_len, params=self._params,
                              mesh=mesh)
        else:
            check_kernel_limits(self.cfg, self.strategy, self.device)
            trainer = Trainer(self.cfg, self.strategy, self.device, tc,
                              data=data, global_batch=global_batch,
                              seq_len=seq_len, params=self.params)
        if restore:
            trainer.maybe_restore()
        return trainer

    def generate(self, prompt, steps: int = 16):
        """Greedy-decode ``steps`` tokens on the session's device.
        ``prompt`` is a (b, s) or (s,) array of token ids, or a model batch
        dict (with ``frames`` for the enc-dec family, ``image_embeds`` for
        the VLM). Returns (b, steps) int32 on the session's device."""
        if isinstance(prompt, dict):
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in prompt.items()}
        else:
            arr = torch.from_numpy(np.asarray(prompt, np.int32))
            if arr.ndim == 1:
                arr = arr[None, :]
            batch = {"tokens": arr.to(self.device)}
        params = tree_map(torch.Tensor.detach, self.params)
        return greedy_generate(params, self.cfg, self.strategy, batch,
                               steps=steps)

    def serve(self, *, plan=None, tp: Optional[int] = None,
              dp: Optional[int] = None, slots: int = 4, max_len: int = 256,
              eos_id: Optional[int] = None, temperature: float = 0.0,
              seed: Optional[int] = None, paged: Optional[bool] = None,
              page_size: int = 16, kv_pages: Optional[int] = None,
              prefix_cache: bool = False, lazy: bool = False,
              scheduler=None, mixed: Optional[bool] = None,
              chunk_tokens: int = 256, attn_backend: Optional[str] = None,
              spec=None, trace_level: int = 1, devices=None):
        """Continuous-batching engine over this session's params on its
        device: for a full-attention dense or MoE decoder or the enc-dec
        audio family the paged pool and ONE mixed token-slot program per
        step by default (each audio request submits its ``frames``);
        otherwise
        (``mixed=False``, ``paged=False``, sliding-window configs, the SSM
        family, the hybrid, the VLM — each VLM request submits its
        ``images``) the split path, one prefill program a request
        and one batched decode a step (see serve/engine.py). ``attn_backend``
        exists for the reference's signature only: the device picks the
        kernel or the plain path.

        The reference's branches (``repro/api/session.py:250-273``):
        ``tp`` and ``dp`` 1 give one engine. ``tp=N`` (N > 1) with ``dp``
        1, called on every rank of an initialised process group of N
        ranks (one process a rank, as ``torchrun`` starts them), builds
        the ("data", "model") = (1, N) mesh on the session's device type
        (``launch/mesh.py``) and returns this rank's tensor-parallel
        engine (serve/engine.py): the session's params sliced to the
        rank's shards, or, when the session has none yet, only the rank's
        shards drawn from its seed. ``dp=M`` (M > 1) returns a
        ``ReplicaRouter`` (serve/parallel.py): at tp 1 in this process,
        replica r on ``devices[r]`` (default: the visible devices of the
        session's type; a list may repeat a device, and the replicas on
        it share the session's weights); at tp N on every rank of a
        process group of M x N ranks, over a (M, N) mesh, each process
        serving its row's replica.

        Defaults come from ``plan`` (an explicit Plan, else the session's
        own from :meth:`from_plan`; reference ``session.py:240-249``):
        its tp and dp; explicit ``tp=`` / ``dp=`` override them, and a
        plan with pp > 1 raises ``ValueError`` unless both are given
        (decode is one token deep). At the plan's degrees the engine
        takes the session's own mesh, and a plan of dp > 1 at tp 1
        materialised on a device list its devices. Under the strategy's
        ``seq_parallel`` / ``fsdp`` the engine serves the Megatron layout
        (``core/strategy.py::serving``), as the reference's does."""
        p = plan if plan is not None else self.plan
        if tp is None or dp is None:
            if p is not None and p.degrees.pp > 1:
                raise ValueError(
                    f"plan[{p.method}] has pp={p.degrees.pp}: pipeline "
                    "parallelism has no serving path (decode is one "
                    "token deep) — re-plan with pp=1 or pass explicit "
                    "tp=/dp= to serve()")
            tp = (p.degrees.tp if p is not None else 1) if tp is None else tp
            dp = (p.degrees.dp if p is not None else 1) if dp is None else dp
        if attn_backend is not None:
            raise ValueError(
                "repro_torch picks the attention path by device (CUDA: "
                "the hand-written kernel, CPU: its plain version); drop "
                f"attn_backend={attn_backend!r}")
        mesh = None
        if tp > 1:
            mesh = self._rank_mesh(dp, tp)
            if mesh is None:
                mesh = make_mesh((dp, tp), ("data", "model"),
                                 device_type=self.device.type)
        elif dp > 1 and devices is None and \
                isinstance(self.mesh, (list, tuple)) and len(self.mesh) == dp:
            devices = [m.devices[0] for m in self.mesh]
        if mesh is not None and self._params is None:
            params = init_params(self.cfg, device=self.device,
                                 seed=self.seed,
                                 shard=(serving(self.strategy), mesh))
        else:
            # serving needs no gradient: detached views of (trained) params
            params = tree_map(torch.Tensor.detach, self.params)
        kw = dict(slots=slots, max_len=max_len, eos_id=eos_id,
                  temperature=temperature,
                  seed=self.seed if seed is None else seed, paged=paged,
                  page_size=page_size, kv_pages=kv_pages,
                  prefix_cache=prefix_cache, lazy=lazy, scheduler=scheduler,
                  mixed=mixed, chunk_tokens=chunk_tokens, spec=spec,
                  trace_level=trace_level)
        if dp > 1:
            from repro_torch.serve.parallel import ReplicaRouter
            return ReplicaRouter(self.cfg, params, dp=dp, tp=tp,
                                 devices=devices, mesh=mesh,
                                 strategy=self.strategy, **kw)
        if devices is not None:
            raise ValueError("devices= places the replicas of dp > 1; one "
                             "engine serves on the session's device")
        return ServeEngine(
            self.cfg, params, device=self.device, mesh=mesh,
            strategy=self.strategy if mesh is not None else None, **kw)

    # ------------------------------------------------------- online serving
    def serve_async(self, *, watchdog_timeout: Optional[float] = None,
                    metrics=None, start: bool = True, **serve_kw):
        """ONLINE serving: :meth:`serve`'s engine (every ``serve`` keyword
        passes through) wrapped in an :class:`~repro_torch.serve.driver.
        AsyncDriver` — the step loop runs on a background thread,
        ``submit()`` takes requests at any time and returns a per-request
        TokenStream, TTFT/TPOT/step latencies land in ``driver.metrics``,
        and ``watchdog_timeout`` arms stalled-step detection with
        cancel-and-requeue recovery. ``start=False`` defers the loop so a
        batch of submissions admits exactly as ``run()`` does.

        With ``tp=`` (and ``dp=``) call it on every rank, as ``serve(tp=)``
        is, and start it on every rank: rank 0's driver takes the
        submissions and broadcasts them, with its deadlines, aborts and
        watchdog requeues, to every rank before each step; another
        rank's driver (``lead`` False) replays them, and its ``stop``
        waits for rank 0's (serve/driver.py)."""
        from repro_torch.serve.driver import AsyncDriver
        return AsyncDriver(self.serve(**serve_kw),
                           watchdog_timeout=watchdog_timeout,
                           metrics=metrics, start=start)

    def serve_http(self, *, host: str = "127.0.0.1", port: int = 0,
                   watchdog_timeout: Optional[float] = None, **serve_kw):
        """:meth:`serve_async` behind the stdlib HTTP front-end
        (serve/server.py): ``POST /generate`` (optionally chunked token
        streaming), ``GET /metrics`` (Prometheus text), ``GET /healthz``.
        ``port=0`` binds a free port — read it back from ``.port``. The
        returned server owns its driver; ``close()`` drains and stops
        both. With ``tp=`` (and ``dp=``) call it on every rank: only rank
        0 binds the port; another rank's server binds nothing, replays
        rank 0's events, and its ``close()`` returns once rank 0 has
        stopped."""
        from repro_torch.serve.server import serve_http
        return serve_http(self.serve(**serve_kw), host=host, port=port,
                          watchdog_timeout=watchdog_timeout)
