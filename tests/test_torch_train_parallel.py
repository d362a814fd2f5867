"""Sharded training in the port (core/tp.py, train/step.py,
train/trainer.py, optim/optimizers.py) on four CPU gloo ranks: the twin
of tests/test_parallel_equivalence.py's ``test_train_step_sharded_
equals_reference`` for the dense and MoE families.

One spawn (``launch/ranks.py``: four ``spawn``-started rank processes,
a FileStore under ``tmp_path``, a timeout that kills the ranks) runs
every case. Each case trains one step (two for Adafactor, so its second
step reads the state blocks the first wrote) of the reference's smoke
config in float32 — ``qwen3-14b`` (Hq 8, Hkv 2: at tp 4 the K/V
projections are whole on every rank, and with ``q_norm``/``k_norm``
their gradients are summed over "model") and ``olmoe-1b-7b`` (E 4, at
the reference test's capacity factor 16.0, and at the default 1.25 on a
batch whose routing drops entries; its experts over "model", and with TP
inside each expert, ``Strategy(expert_parallel=False)``: every expert
and d_ff / tp of each on a rank, at (2, 2) with Megatron, +SP,
+FSDP+SP+remat and drops, and at (1, 4)) — on a ("data", "model") mesh, from
the JAX init's params through the weight bridge, on the global batch
(the step takes the rank's rows). Each is held:

* to the JAX package's unsharded ``make_train_step`` on the same params
  and batch: loss within abs 1e-4 and every param block within atol /
  rtol 5e-4 of the reference's new params at the rank's block (the
  reference test's bounds); ``aux_loss`` and ``grad_norm`` within rel
  1e-5;
* to the port's one-device step: each rank's gradient update block
  before clipping within atol 1e-6 + rtol 1e-5 of the one-device
  gradient's block (only the order of fp32 sums differs);
* loss, aux loss and grad norm equal bit for bit on every rank, and the
  data replicas' param blocks equal bit for bit;
* the blocks a rank holds: its param blocks the shapes of the port's
  table (FSDP: "data" on the first free divisible dim), its AdamW
  ``m``/``v``/``master`` and Adafactor ``vr``/``vc`` the blocks of
  ``core/sharding.py``'s state specs (ZeRO-1 over "data"), smaller than
  the param blocks where they split.

The SSM family (``mamba2-780m``, the reference test's third arch, at (2,
2) with Megatron, +SP and +FSDP and at (1, 4); two Adafactor steps at
(2, 2)) and the hybrid
(``zamba2-1.2b`` at (2, 2)) train the same way, each rank holding a
Mamba2 block of whole heads (``in_proj`` and the conv by head with all of
B and C): the same bounds, and a checkpoint of their sharded trees equal
to the unsharded tree leaf for leaf.

The enc-dec family (``whisper-tiny``'s smoke, its frames a seeded numpy
block beside the tokens) trains at (2, 2) with Megatron, +SP and
+FSDP+SP+remat and at (1, 4): the same bounds, and its collectives by
label (the backward sum of ``enc_out`` into each decoder layer's cross
K/V, ``cross_in.grad``, among them).

The VLM (``llama-3.2-vision-90b``'s smoke, its gates opened to 1.0 on
the JAX init, a seeded numpy block of images beside the tokens) trains
at (2, 2) with Megatron, +SP, +FSDP+SP+remat and Adafactor, and at (1,
4): the same bounds, and its collectives by label (the gates' gradient
sums under SP only, no sum into the images).

The same spawn trains through ``Session.train(tp=2, dp=2)`` (a
checkpoint at step 2 that a one-device trainer restores leaf for leaf,
and a (2, 2) trainer cuts to its blocks; whisper's on ``FramesData``
too; the olmoe smoke with TP inside each expert, whose checkpoint an
expert-parallel (2, 2) trainer restores), and through ``launch/train.py
--dp 2 --tp 2 --fsdp`` (and ``--arch mamba2-780m --seq-parallel``,
``--arch whisper-tiny --seq-parallel``, ``--arch llama-3.2-vision-90b
--seq-parallel``).

The same spawn trains two planner Plans through ``Session.from_plan``
(tests/test_api_session.py's config and shape, the port's plan on H100,
the reference's on H100's fields): the "dp" search's dp 2 x tp 2 plan
with sequence parallelism, and a dp 1 x pp 2 x tp 2 plan on the
("data", "pipe", "model") mesh, where each "pipe" slice holds whole
replicas (the reference's Trainer never runs the pipeline either). Each
is held to JAX's ``Session.from_plan(..., devices=4)`` on the same init
(the params setter) within the reference test's bounds; the pipe
replicas' blocks are equal bit for bit, one checkpoint of the full tree
is written, and ``serve()`` of the pp 2 plan raises the reference's
``ValueError``.

The same spawn trains on ("pod", "data", "model") meshes (2, 1, 2) and,
with ZeRO-1, (2, 2, 1): the batch rows, the loss normaliser and the
gradient sums over pod x data, ZeRO-1's blocks over "data" alone; and a
config of 6 query heads at (1, 4) (``Rank.whole_heads``: every rank runs
all six, with and without SP). Each is held to JAX's unsharded step as
above. The olmoe smoke trains at (2, 1, 2) too, on the batch that drops
entries: its capacity split over pod x data. On the (2, 2) mesh and the
pod meshes each rank also counts its real step (``launch/roofline.py::Counter``), and ``Session.lower`` of
the same step as that rank on meta (a "cpu" session, here in the test's
process) must count the same FLOPs, bytes and collectives by label,
exactly.

This module imports JAX and the reference only in this process; the
ranks import ``repro_torch`` only.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import tp  # noqa: E402
from repro_torch.core.pspec import P  # noqa: E402
from repro_torch.core.sharding import _state_leaf_spec  # noqa: E402
from repro_torch.core.strategy import Strategy  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402
from repro_torch.params import from_numpy, full_shapes  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

RANK_TIMEOUT = 240.0            # seconds the spawn may take before it fails
LR = 1e-3                       # the reference test's
LOSS_TOL, PARAM_TOL = 1e-4, 5e-4        # the reference test's bounds
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5       # vs the port's one-device step
METRIC_REL = 1e-5

VLM = "llama-3.2-vision-90b"
#: the qwen3 smoke with 6 query heads (Hkv 2): at tp 4 they do not split
QWEN6 = "qwen3-14b/6 heads"
#: arch -> (the smoke it varies, its config overrides)
VARIANTS = {QWEN6: ("qwen3-14b", dict(num_heads=6))}

#: the Strategy keyword of TP inside each expert
TIE = dict(expert_parallel=False)

#: case -> (arch, (data, model), Strategy keywords, capacity factor,
#: batch, steps)
CASES = {
    "qwen 2x2": ("qwen3-14b", (2, 2), {}, 16.0, "uniform", 1),
    "qwen 2x2 sp": ("qwen3-14b", (2, 2), dict(seq_parallel=True), 16.0,
                    "uniform", 1),
    "qwen 2x2 fsdp": ("qwen3-14b", (2, 2), dict(fsdp=True), 16.0,
                      "uniform", 1),
    "qwen 2x2 fsdp sp remat": ("qwen3-14b", (2, 2),
                               dict(fsdp=True, seq_parallel=True,
                                    remat=True), 16.0, "uniform", 1),
    "qwen 1x4": ("qwen3-14b", (1, 4), {}, 16.0, "uniform", 1),
    "qwen 4x1": ("qwen3-14b", (4, 1), {}, 16.0, "uniform", 1),
    "qwen 2x2 adafactor": ("qwen3-14b", (2, 2),
                           dict(optimizer="adafactor"), 16.0, "uniform", 2),
    "olmoe 2x2": ("olmoe-1b-7b", (2, 2), {}, 16.0, "uniform", 1),
    "olmoe 2x2 sp": ("olmoe-1b-7b", (2, 2), dict(seq_parallel=True), 16.0,
                     "uniform", 1),
    "olmoe 2x2 fsdp": ("olmoe-1b-7b", (2, 2), dict(fsdp=True), 16.0,
                       "uniform", 1),
    "olmoe 1x4": ("olmoe-1b-7b", (1, 4), {}, 16.0, "uniform", 1),
    "olmoe 4x1": ("olmoe-1b-7b", (4, 1), {}, 16.0, "uniform", 1),
    "olmoe 2x2 microbatches": ("olmoe-1b-7b", (2, 2),
                               dict(microbatches=2), 16.0, "uniform", 1),
    "olmoe 2x2 drops": ("olmoe-1b-7b", (2, 2), {}, 1.25, "skewed", 1),
    # TP inside each expert: every expert on every rank, its d_ff over
    # "model" (the JAX reference runs are the cases above: the unsharded
    # step does not depend on the layout)
    "olmoe 2x2 tie": ("olmoe-1b-7b", (2, 2), dict(TIE), 16.0, "uniform", 1),
    "olmoe 2x2 tie sp": ("olmoe-1b-7b", (2, 2),
                         dict(TIE, seq_parallel=True), 16.0, "uniform", 1),
    "olmoe 2x2 tie fsdp sp remat": ("olmoe-1b-7b", (2, 2),
                                    dict(TIE, fsdp=True, seq_parallel=True,
                                         remat=True), 16.0, "uniform", 1),
    "olmoe 1x4 tie": ("olmoe-1b-7b", (1, 4), dict(TIE), 16.0, "uniform", 1),
    "olmoe 2x2 tie drops": ("olmoe-1b-7b", (2, 2), dict(TIE), 1.25,
                            "skewed", 1),
    # Adafactor's factored statistics over the (L, E, d, f / tp) blocks
    # (d 128 is not f / tp 32: the reference's vr / vc specs are told apart)
    "olmoe 2x2 tie adafactor": ("olmoe-1b-7b", (2, 2),
                                dict(TIE, optimizer="adafactor"), 16.0,
                                "uniform", 2),
    # the SSM family (the reference test's third arch) and the hybrid: a
    # Mamba2 block split by whole heads over "model"
    "mamba 2x2": ("mamba2-780m", (2, 2), {}, 16.0, "uniform", 1),
    "mamba 2x2 sp": ("mamba2-780m", (2, 2), dict(seq_parallel=True), 16.0,
                     "uniform", 1),
    "mamba 2x2 fsdp": ("mamba2-780m", (2, 2), dict(fsdp=True), 16.0,
                       "uniform", 1),
    "mamba 1x4": ("mamba2-780m", (1, 4), {}, 16.0, "uniform", 1),
    "mamba 2x2 adafactor": ("mamba2-780m", (2, 2),
                            dict(optimizer="adafactor"), 16.0, "uniform", 2),
    "zamba 2x2": ("zamba2-1.2b", (2, 2), {}, 16.0, "uniform", 1),
    # the enc-dec family: frames beside the tokens, the cross K/V of the
    # rank's heads, the encoder's and decoder's sequences split under SP
    "whisper 2x2": ("whisper-tiny", (2, 2), {}, 16.0, "uniform", 1),
    "whisper 2x2 sp": ("whisper-tiny", (2, 2), dict(seq_parallel=True),
                       16.0, "uniform", 1),
    "whisper 2x2 fsdp sp remat": ("whisper-tiny", (2, 2),
                                  dict(fsdp=True, seq_parallel=True,
                                       remat=True), 16.0, "uniform", 1),
    "whisper 1x4": ("whisper-tiny", (1, 4), {}, 16.0, "uniform", 1),
    # the VLM (its gates opened on the JAX init): images beside the
    # tokens, whole on every "model" rank; at (1, 4) Hkv 2 over tp 4 keeps
    # wk / wv whole (self and image K/V) and each rank reads its one head
    "vlm 2x2": (VLM, (2, 2), {}, 16.0, "uniform", 1),
    "vlm 2x2 sp": (VLM, (2, 2), dict(seq_parallel=True), 16.0, "uniform",
                   1),
    "vlm 2x2 fsdp sp remat": (VLM, (2, 2),
                              dict(fsdp=True, seq_parallel=True,
                                   remat=True), 16.0, "uniform", 1),
    "vlm 1x4": (VLM, (1, 4), {}, 16.0, "uniform", 1),
    "vlm 2x2 adafactor": (VLM, (2, 2), dict(optimizer="adafactor"), 16.0,
                          "uniform", 2),
    # ("pod", "data", "model"): rows and gradient sums over pod x data,
    # ZeRO-1's blocks over "data" alone
    "qwen pod 2x1x2": ("qwen3-14b", (2, 1, 2), {}, 16.0, "uniform", 1),
    "qwen pod 2x2x1": ("qwen3-14b", (2, 2, 1), dict(zero1=True), 16.0,
                       "uniform", 1),
    # the MoE's capacity split over pod x data, with drops: global slots
    # still decide which entries an expert keeps
    "olmoe pod 2x1x2 drops": ("olmoe-1b-7b", (2, 1, 2), {}, 1.25, "skewed",
                              1),
    # 6 query heads over tp 4: every rank runs all of them
    "qwen6 1x4": (QWEN6, (1, 4), {}, 16.0, "uniform", 1),
    "qwen6 1x4 sp": (QWEN6, (1, 4), dict(seq_parallel=True), 16.0,
                     "uniform", 1),
}

#: the cases each rank also counts, held to ``Session.lower`` on meta
COUNTED = ("qwen 2x2", "qwen pod 2x1x2", "qwen pod 2x2x1",
           "olmoe pod 2x1x2 drops")

#: the batches: 4 x 64 tokens over the whole vocabulary, and over its
#: first 4 ids (the router sends them to few experts: at the default
#: capacity factor entries drop)
BATCHES = {"uniform": 512, "skewed": 4}

#: tests/test_api_session.py's CFG and SHAPE, the plans' config and shape
PLAN_KW = dict(name="api-test", arch_type="dense", num_layers=2,
               d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
               vocab_size=128, dtype="float32")
PLAN_SHAPE = ("host", 64, 8, "train")
#: the reference test's Strategy overrides, and the Trainer's batch
PLAN_KNOBS = dict(remat=False, microbatches=1, dtype="float32")
PLAN_TRAIN = dict(global_batch=8, seq_len=32)
#: plan name -> Degrees keywords (None: the "dp" search at 4 chips)
PLANS = {"dp": None, "pipe": dict(dp=1, tp=2, pp=2)}

_JAX = {}


def _tokens(kind):
    return np.random.default_rng(7).integers(
        0, BATCHES[kind], size=(4, 64)).astype(np.int32)


def _batch(arch, kind):
    """The case's numpy batch: ``_tokens``, and for the enc-dec family a
    (4, encoder_ctx, d_model) block of standard-normal frames, for the VLM
    a (4, num_image_tokens, d_model) block of images, each from a seed of
    its own."""
    out = {"tokens": _tokens(kind)}
    media = {"whisper-tiny": ("frames", "encoder_ctx", 8),
             VLM: ("image_embeds", "num_image_tokens", 9)}.get(arch)
    if media is not None:
        key, length, seed = media
        kw = _cfg_kw(arch, 16.0)
        out[key] = np.random.default_rng(seed).standard_normal(
            (4, kw[length], kw["d_model"])).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _strategy_kw(case):
    arch, _, kw, _, _, _ = CASES[case]
    return dict(dict(remat=False, microbatches=1, dtype="float32"), **kw)


def _ref_key(case):
    """What the unsharded step depends on: the sharding knobs do not."""
    arch, _, kw, cf, batch, steps = CASES[case]
    return (arch, cf, batch, kw.get("optimizer", "adamw"),
            kw.get("microbatches", 1), steps)


def _cfg_kw(arch, cf):
    from repro.configs import get_smoke
    arch, over = VARIANTS.get(arch, (arch, {}))
    return dict(get_smoke(arch).with_(dtype="float32",
                                      moe_capacity_factor=cf,
                                      **over).__dict__)


def _jax_ref(key):
    """The JAX package's unsharded step(s) for ``key`` (``_ref_key``): (cfg
    keywords, the init flattened, [(new params flattened, metrics) a
    step]); made once a key. A VLM's init has both gates opened to 1.0:
    at 0 no cross weight gets a gradient and a cross layer's defect
    hides."""
    if key not in _JAX:
        import jax
        import jax.numpy as jnp
        from repro.checkpoint.io import _flatten
        from repro.configs.base import ModelConfig as JaxConfig
        from repro.core.strategy import Strategy as JaxStrategy
        from repro.models import get_model
        from repro.train import step as jstep
        arch, cf, batch, optimizer, micro, steps = key
        kw = _cfg_kw(arch, cf)
        jcfg = JaxConfig(**kw)
        params = get_model(jcfg).init(jax.random.key(0), jcfg)
        if jcfg.arch_type == "vlm":
            for gate in ("gate_attn", "gate_mlp"):
                params["cross"][gate] = jnp.ones_like(params["cross"][gate])
        st = JaxStrategy(remat=False, microbatches=micro, dtype="float32",
                         optimizer=optimizer)
        step = jax.jit(jstep.make_train_step(jcfg, st, lr=LR))
        p, o = params, jstep.init_opt_state(params, st)
        data = {k: jnp.asarray(v) for k, v in _batch(arch, batch).items()}
        out = []
        for _ in range(steps):
            p, o, m = step(p, o, data)
            out.append(({k: np.asarray(v) for k, v in _flatten(p).items()},
                        {k: float(v) for k, v in m.items()}))
        _JAX[key] = (kw, {k: np.asarray(v)
                          for k, v in _flatten(params).items()}, out)
    return _JAX[key]


def _one_device_grads(case):
    """The port's one-device gradients (before clipping) of the case's
    first step."""
    key = ("grads",) + _ref_key(case)
    if key not in _JAX:
        kw, flat, _ = _jax_ref(_ref_key(case))
        cfg = ModelConfig(**kw)
        st = Strategy(**_strategy_kw(case))
        params = from_numpy(flat, cfg, "cpu")
        g, _ = tstep.make_train_step(cfg, st, lr=LR).grads(
            params, _torch_batch(_batch(CASES[case][0], CASES[case][4])))
        _JAX[key] = {k: v.numpy().copy() for k, v in flatten(g).items()}
    return _JAX[key]


def _jax_plan_ref(name):
    """JAX's ``Session.from_plan(..., devices=4)`` of plan ``name`` (the
    "dp" search on H100's fields, or ``PLANS[name]``'s degrees), two
    steps: (the plan's row, the session's init flattened, the losses, the
    trained params flattened); made once."""
    key = ("plan", name)
    if key not in _JAX:
        from repro.api import Degrees as JaxDegrees
        from repro.api import Plan as JaxPlan
        from repro.api import Session as JaxSession
        from repro.api import plan as jax_plan
        from repro.checkpoint.io import _flatten
        from repro.configs.base import ModelConfig as JaxConfig
        from repro.configs.base import ShapeConfig as JaxShape
        from repro.core.costmodel import Hardware as JaxHardware
        from repro.train.trainer import TrainConfig as JaxTrainConfig
        from repro_torch.core.costmodel import H100
        jcfg, shape = JaxConfig(**PLAN_KW), JaxShape(*PLAN_SHAPE)
        hw = JaxHardware(**dataclasses.asdict(H100))
        p = jax_plan(jcfg, shape, 4, method="dp", hw=hw) \
            if PLANS[name] is None else \
            JaxPlan.from_degrees(jcfg, shape, JaxDegrees(**PLANS[name]), hw)
        session = JaxSession.from_plan(jcfg, p, devices=4, **PLAN_KNOBS)
        init = {k: np.asarray(v).copy()
                for k, v in _flatten(session.params).items()}
        trainer = session.train(JaxTrainConfig(steps=2, lr=LR, log_every=1,
                                               seed=3), **PLAN_TRAIN)
        trainer.run()
        _JAX[key] = (p.row(), init, [h["loss"] for h in trainer.history],
                     {k: np.array(v)
                      for k, v in _flatten(session.params).items()})
    return _JAX[key]


# ----------------------------------------------------------- the ranks

def _mesh_names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _meshes():
    from repro_torch.launch.mesh import make_mesh
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = make_mesh(shape, _mesh_names(shape),
                                     device_type="cpu")
        return cache[shape]
    return get


def _case_rank(mesh, case, kw, flat, data):
    """One case on this rank: the rank's blocks after each step, its
    first step's gradient blocks, metrics, state and param shapes."""
    cfg = ModelConfig(**kw)
    st = Strategy(**_strategy_kw(case))
    steps = CASES[case][5]
    rank = tp.Rank.of(mesh, cfg, st, full_shapes(cfg))
    params = from_numpy(flat, cfg, "cpu", shard=(st, mesh))
    batch = _torch_batch(data)
    step = tstep.make_train_step(cfg, st, lr=LR)
    out = {"coord": tp.coordinate(mesh), "metrics": [], "params": []}
    with tp.active(rank):
        opt = tstep.init_opt_state(params, st)
        g, _ = step.grads(params, batch)
        out["grads"] = {k: v.numpy().copy() for k, v in flatten(g).items()}
        del g
        rank.counts.clear()
        for _ in range(steps):
            params, opt, m = step(params, opt, batch)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["params"].append({k: v.detach().numpy().copy()
                                  for k, v in flatten(params).items()})
    out["counts"] = dict(rank.counts)
    out["split_rows_after"] = rank.split_rows
    out["state"] = {name: {k: tuple(v.shape)
                           for k, v in flatten(opt[name]).items()}
                    for name in opt if name != "step"}
    return out


def _counted_rank(mesh, case, kw, flat, data):
    """One step of ``case`` on this rank under ``Counter``: its FLOPs,
    bytes, kernels and collectives."""
    from repro_torch.launch.roofline import Counter
    cfg = ModelConfig(**kw)
    st = Strategy(**_strategy_kw(case))
    rank = tp.Rank.of(mesh, cfg, st, full_shapes(cfg))
    params = from_numpy(flat, cfg, "cpu", shard=(st, mesh))
    batch = _torch_batch(data)
    step = tstep.make_train_step(cfg, st, lr=LR)
    with tp.active(rank):
        opt = tstep.init_opt_state(params, st)
        counter = Counter(rank)
        with counter:
            step(params, opt, batch)
    return {"coord": tp.coordinate(mesh), "rank": torch.distributed.get_rank(),
            "flops": counter.flops, "bytes": counter.bytes,
            "kernels": counter.kernels, "collectives": counter.collectives}


def _session_rank(tmp, flat_kw):
    """``Session.train(tp=2, dp=2)`` for two steps with a checkpoint at
    step 2; then a (2, 2) trainer on other params restoring it."""
    from repro_torch.api import Session
    from repro_torch.train.trainer import TrainConfig
    kw, flat = flat_kw
    cfg = ModelConfig(**kw).with_(num_layers=2)
    st = Strategy(remat=True, dtype="float32")
    tc = TrainConfig(steps=2, lr=LR, log_every=1, checkpoint_every=2,
                     checkpoint_dir=tmp, seed=3)
    trainer = Session(cfg, strategy=st, device="cpu", seed=3).train(
        tc, global_batch=4, seq_len=16, tp=2, dp=2)
    hist = trainer.run()["history"]
    blocks = {k: v.detach().numpy().copy()
              for k, v in flatten(trainer.params).items()}
    other = Session(cfg, strategy=st, device="cpu", seed=9).train(
        tc, global_batch=4, seq_len=16, tp=2, dp=2, restore=True)
    restored = {k: v.detach().numpy().copy()
                for k, v in flatten(other.params).items()}
    master = {k: v.numpy().copy()
              for k, v in flatten(other.opt_state["master"]).items()}
    return {"history": hist, "blocks": blocks, "restored": restored,
            "restored_step": other.step, "master": master,
            "full_shapes": {k: tuple(v) for k, v in
                            full_shapes(cfg).items()}}


def _ssm_checkpoint_rank(get_mesh, tmp, flats):
    """A (2, 2) FSDP trainer of each SSM smoke on the full JAX init (the
    trainer cuts the rank's blocks) writes its checkpoint at step 0; a
    (2, 2) trainer on other params restores it. Returns the restored
    blocks."""
    from repro_torch.train.trainer import TrainConfig, Trainer
    mesh = get_mesh((2, 2))
    st = Strategy(fsdp=True, remat=False, dtype="float32")
    out = {}
    for arch, (kw, flat) in flats.items():
        cfg = ModelConfig(**kw)
        tc = TrainConfig(steps=1, checkpoint_dir=f"{tmp}/{arch}", seed=3)
        Trainer(cfg, st, "cpu", tc, global_batch=4, seq_len=64,
                params=from_numpy(flat, cfg, "cpu"), mesh=mesh).save(0)
        other = Trainer(cfg, st, "cpu", tc, global_batch=4, seq_len=64,
                        mesh=mesh)
        other.maybe_restore()
        out[arch] = {k: v.detach().numpy().copy()
                     for k, v in flatten(other.params).items()}
    return out


def _tie_checkpoint_rank(tmp):
    """``Session.train(tp=2, dp=2)`` of the olmoe smoke with TP inside each
    expert for one step, its checkpoint at step 1; then an expert-parallel
    (2, 2) trainer on other params restoring it. Returns both runs'
    blocks."""
    from repro_torch.api import Session
    from repro_torch.configs import get_smoke
    from repro_torch.train.trainer import TrainConfig
    cfg = get_smoke("olmoe-1b-7b").with_(dtype="float32")
    tc = TrainConfig(steps=1, lr=LR, log_every=1, checkpoint_every=1,
                     checkpoint_dir=f"{tmp}/olmoe_tie", seed=3)
    out = {}
    for name, st, seed, restore in (("tie", TIE_SESSION_ST, 3, False),
                                    ("ep", EP_SESSION_ST, 9, True)):
        trainer = Session(cfg, strategy=st, device="cpu", seed=seed).train(
            tc, global_batch=4, seq_len=16, tp=2, dp=2, restore=restore)
        if not restore:
            trainer.run()
        out[name] = {k: v.detach().numpy().copy()
                     for k, v in flatten(trainer.params).items()}
        out[f"{name}_step"] = trainer.step
    return out


def _encdec_session_rank(tmp):
    """``Session.train(tp=2, dp=2)`` of the whisper smoke with sequence
    parallelism on ``FramesData``, two steps and a checkpoint at step 2:
    the history and the rank's blocks."""
    from repro_torch.api import Session
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import FramesData
    from repro_torch.train.trainer import TrainConfig
    cfg = get_smoke("whisper-tiny").with_(dtype="float32")
    tc = TrainConfig(steps=2, lr=LR, log_every=1, checkpoint_every=2,
                     checkpoint_dir=f"{tmp}/whisper", seed=3)
    trainer = Session(cfg, strategy=ENCDEC_SESSION_ST, device="cpu",
                      seed=3).train(tc, data=FramesData(
                          cfg, global_batch=4, seq_len=16, seed=3),
                          global_batch=4, seq_len=16, tp=2, dp=2)
    hist = trainer.run()["history"]
    return {"history": hist,
            "blocks": {k: v.detach().numpy().copy()
                       for k, v in flatten(trainer.params).items()}}


def _plan_rank(tmp, inits):
    """Each of ``PLANS`` through ``Session.from_plan`` on the four
    ranks, from JAX's init (the params setter): two steps (the pipe plan
    with a checkpoint at step 2), the losses and the rank's blocks; then
    ``serve()``, which a pp 2 plan refuses."""
    from repro_torch.api import Degrees, Plan, Session, plan
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.strategy import mesh_axes
    from repro_torch.train.trainer import TrainConfig
    cfg, shape = ModelConfig(**PLAN_KW), ShapeConfig(*PLAN_SHAPE)
    out = {}
    for name, deg in PLANS.items():
        p = plan(cfg, shape, 4, method="dp") if deg is None else \
            Plan.from_degrees(cfg, shape, Degrees(**deg))
        session = Session.from_plan(cfg, p, device="cpu", **PLAN_KNOBS)
        session.params = from_numpy(inits[name], cfg, "cpu")
        tc = TrainConfig(steps=2, lr=LR, log_every=1, seed=3,
                         checkpoint_every=2 if name == "pipe" else 0,
                         checkpoint_dir=f"{tmp}/plan_{name}")
        trainer = session.train(tc, **PLAN_TRAIN)
        trainer.run()
        rec = {"row": p.row(),
               "strategy": dataclasses.asdict(session.strategy),
               "axes": mesh_axes(session.mesh),
               "coord": tp.coordinate(session.mesh),
               "losses": [h["loss"] for h in trainer.history],
               "blocks": {k: v.detach().numpy().copy()
                          for k, v in flatten(trainer.params).items()}}
        if name == "pipe":
            try:
                session.serve()
            except ValueError as e:
                rec["serve"] = str(e)
        out[name] = rec
    return out


def _all_ranks(rank, world, refs, tmp):
    """Every case of this module on one rank: one spawn for all."""
    torch.set_num_threads(1)
    from repro_torch.launch import train as launcher
    get_mesh = _meshes()
    out = {"cases": {}}
    for case, (kw, flat, tokens) in refs["cases"].items():
        out["cases"][case] = _case_rank(get_mesh(CASES[case][1]), case, kw,
                                        flat, tokens)
    out["counted"] = {case: _counted_rank(get_mesh(CASES[case][1]), case,
                                          *refs["cases"][case])
                      for case in COUNTED}
    out["session"] = _session_rank(tmp, refs["session"])
    out["launcher"] = launcher.main(
        ["--device", "cpu", "--dp", "2", "--tp", "2", "--fsdp", "--steps",
         "2", "--global-batch", "4", "--seq", "16", "--layers", "2"])
    out["ssm_launcher"] = launcher.main(
        ["--device", "cpu", "--arch", "mamba2-780m", "--dp", "2", "--tp",
         "2", "--fsdp", "--seq-parallel", "--steps", "2", "--global-batch",
         "4", "--seq", "64"])
    out["encdec_launcher"] = launcher.main(
        ["--device", "cpu", "--arch", "whisper-tiny", "--dp", "2", "--tp",
         "2", "--seq-parallel", "--steps", "2", "--global-batch", "4",
         "--seq", "16"])
    out["vlm_launcher"] = launcher.main(
        ["--device", "cpu", "--arch", VLM, "--dp", "2", "--tp", "2",
         "--seq-parallel", "--steps", "2", "--global-batch", "4", "--seq",
         "16"])
    out["encdec_session"] = _encdec_session_rank(tmp)
    out["ssm_checkpoint"] = _ssm_checkpoint_rank(get_mesh, tmp,
                                                 refs["ssm_checkpoint"])
    out["tie_checkpoint"] = _tie_checkpoint_rank(tmp)
    out["plan"] = _plan_rank(tmp, refs["plan"])
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank's results of every case, from one spawn."""
    cases = {}
    for case in CASES:
        kw, flat, _ = _jax_ref(_ref_key(case))
        cases[case] = (kw, flat, _batch(CASES[case][0], CASES[case][4]))
    kw, flat, _ = _jax_ref(_ref_key("qwen 2x2"))
    refs = {"cases": cases, "session": (kw, flat),
            "ssm_checkpoint": {arch: _jax_ref(_ref_key(case))[:2]
                               for arch, case in SSM_CHECKPOINTS.items()},
            "plan": {name: _jax_plan_ref(name)[1] for name in PLANS}}
    tmp = str(tmp_path_factory.mktemp("ckpt"))
    ranks = run_ranks(_all_ranks, 4, args=(refs, tmp),
                      store_dir=str(tmp_path_factory.mktemp("store")),
                      timeout=RANK_TIMEOUT)
    return ranks, tmp


def _axes(case):
    shape = CASES[case][1]
    return dict(zip(_mesh_names(shape), shape))


def _leaves(case):
    kw = _jax_ref(_ref_key(case))[0]
    cfg = ModelConfig(**kw)
    return cfg, tp.leaf_blocks(full_shapes(cfg), Strategy(
        **_strategy_kw(case)), _axes(case), cfg)


def _block(full, spec, case, coord):
    return tp.shard_leaf(torch.from_numpy(np.array(full)),
                         spec, _axes(case), coord).numpy()


# ------------------------------------------------------------ the cases

@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_jax_unsharded(spawned, case):
    """Loss within 1e-4, every param block within atol / rtol 5e-4 of the
    reference's unsharded step (each step of it), ``aux_loss`` and
    ``grad_norm`` within rel 1e-5; the metrics equal on every rank, the
    data replicas' blocks equal bit for bit; no step's mark of split rows
    left on the rank after it."""
    ranks, _ = spawned
    _, leaves = _leaves(case)
    _, _, ref = _jax_ref(_ref_key(case))
    runs = [r["cases"][case] for r in ranks]
    assert not any(run["split_rows_after"] for run in runs)
    for i, (jparams, jmet) in enumerate(ref):
        for run in runs:
            m = run["metrics"][i]
            assert m == runs[0]["metrics"][i]
            assert m["loss"] == pytest.approx(jmet["loss"], abs=LOSS_TOL)
            for k in ("aux_loss", "grad_norm"):
                assert m[k] == pytest.approx(jmet[k], rel=METRIC_REL,
                                             abs=1e-7), k
            for key, block in run["params"][i].items():
                want = _block(jparams[key], leaves[key].spec, case,
                              run["coord"])
                np.testing.assert_allclose(block, want, atol=PARAM_TOL,
                                           rtol=PARAM_TOL,
                                           err_msg=f"{case} step {i} {key}")
        for a in runs:
            for b in runs:
                if a["coord"]["model"] != b["coord"]["model"]:
                    continue
                for key, lb in leaves.items():
                    if lb.fsdp_dim is None:
                        assert np.array_equal(a["params"][i][key],
                                              b["params"][i][key]), key


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_grads_match_one_device(spawned, case):
    """Each rank's gradient update block before clipping (summed over
    "data", ZeRO-1's slice) within atol 1e-6 + rtol 1e-5 of the port's
    one-device gradient at that block."""
    ranks, _ = spawned
    _, leaves = _leaves(case)
    want = _one_device_grads(case)
    for r in ranks:
        run = r["cases"][case]
        for key, g in run["grads"].items():
            np.testing.assert_allclose(
                g, _block(want[key], leaves[key].update, case, run["coord"]),
                atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=f"{case} {key}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_rank_holds_its_blocks(spawned, case):
    """A rank's params are its blocks of the port's table (FSDP: "data"
    on the first free divisible dim) and its optimizer state the blocks
    of ``core/sharding.py``'s state specs over them (ZeRO-1 over
    "data"): by shape, and smaller than the params where "data"
    splits."""
    from repro_torch.optim.optimizers import _factored_dims
    ranks, _ = spawned
    _, leaves = _leaves(case)
    axes, kw = _axes(case), _strategy_kw(case)
    zero1 = Strategy(**kw).zero1

    def state_shape(name, shape):
        if name == "vr" and _factored_dims(shape) is not None:
            return shape[:-1]
        if name == "vc":
            return () if _factored_dims(shape) is None \
                else shape[:-2] + shape[-1:]
        return shape

    for r in ranks:
        run = r["cases"][case]
        for key, lb in leaves.items():
            assert run["params"][0][key].shape == \
                tp.local_shape(lb.shape, lb.spec, axes), key
            for name, sub in run["state"].items():
                sshape = state_shape(name, lb.shape)
                spec = _state_leaf_spec(tp.Shape(sshape), tp.Shape(lb.shape),
                                        lb.spec, axes, zero1)
                assert sub[key] == tp.local_shape(sshape, spec, axes), \
                    (name, key, sub[key], spec)
        if axes["data"] == 1:
            continue
        # what "data" saves: FSDP's param blocks against the model-only
        # blocks, ZeRO-1's state against the param blocks
        blocks = sum(np.prod(tp.local_shape(lb.shape, lb.spec, axes))
                     for lb in leaves.values())
        if kw.get("fsdp"):
            model_only = sum(np.prod(tp.local_shape(lb.shape, P(*(
                None if a == "data" else a for a in lb.spec)), axes))
                for lb in leaves.values())
            assert blocks < 0.6 * model_only
        else:
            first = next(iter(run["state"]))
            held = sum(np.prod(s) for s in run["state"][first].values())
            assert held < 0.6 * blocks


def test_default_capacity_drops_entries():
    """The "drops" case's batch overflows experts at the default capacity
    factor in the one-device step (so the data ranks' slot offsets
    decide which entries stay), and the reference batch does not at
    16.0."""
    from repro_torch.models import moe
    dropped = {}
    for case in ("olmoe 2x2 drops", "olmoe 2x2"):
        kw, flat, _ = _jax_ref(_ref_key(case))
        cfg = ModelConfig(**kw)
        seen = []
        real = moe.dispatch

        def counting(idx, cfg_, cap, offset=None):
            dest, keep = real(idx, cfg_, cap, offset)
            seen.append(int((~keep).sum()))
            return dest, keep
        moe.dispatch = counting
        try:
            params = from_numpy(flat, cfg, "cpu")
            with torch.no_grad():
                tstep.make_loss_fn(cfg, Strategy(remat=False,
                                                 dtype="float32"))(
                    params, {"tokens": torch.from_numpy(
                        _tokens(CASES[case][4]))})
        finally:
            moe.dispatch = real
        dropped[case] = sum(seen)
    assert dropped["olmoe 2x2 drops"] > 0
    assert dropped["olmoe 2x2"] == 0


def test_collectives_by_label(spawned):
    """A step's collectives carry their labels: at (2, 2) one
    ``attn_out`` and ``mlp_out`` sum a layer forward and one ``attn_in``
    and ``mlp_in`` gradient sum a layer backward, the gradient sums over
    "data" and ZeRO-1's assembly one a leaf; under sequence parallelism
    the gathers and the reduce-scatters' backward; under FSDP a gather a
    layer leaf forward and backward and no "data" gradient sum. An MoE
    layer: ``moe_counts``, ``moe_out`` and ``moe_in.grad`` once each; with
    TP inside each expert also ``moe_gate.grad`` (the gates' gradient a
    partial over each expert's d_ff), and under SP the reduce-scatter's
    ``moe_out.grad`` in place of ``moe_seq.grad``."""
    ranks, _ = spawned
    layers, n_leaves = 2, 14
    for r in ranks:
        c = r["cases"]["qwen 2x2"]["counts"]
        assert c["attn_out"] == c["mlp_out"] == layers
        assert c["attn_in.grad"] == c["mlp_in.grad"] == layers
        assert c["qk_norm.grad"] == 2 * layers
        assert c["dp_grads"] == n_leaves and c["embed"] == 1
        assert 0 < c["zero_params"] <= n_leaves
        assert c["metrics"] == 1 and c["loss_tokens"] == 1
        s = r["cases"]["qwen 2x2 sp"]["counts"]
        for key in ("attn_seq", "mlp_seq", "attn_out.grad", "mlp_out.grad"):
            assert s[key] == layers, key
        assert s["head_seq"] == 1 and s["embed.grad"] == 1
        f = r["cases"]["qwen 2x2 fsdp"]["counts"]
        assert "dp_grads" not in f and "zero_params" not in f
        assert f["fsdp_gather"] == f["fsdp_gather.grad"] > 0
        k = r["cases"]["qwen 1x4"]["counts"]
        assert k["kv_proj.grad"] == 2 * layers          # wk, wv whole
        m = r["cases"]["olmoe 2x2"]["counts"]
        assert m["moe_counts"] == m["moe_out"] == m["moe_in.grad"] == layers
        assert "moe_gate.grad" not in m
        # each data rank's capacity slice: the dispatch buffer's
        # reduce-scatter and the products' gather, and their backward
        for case in ("olmoe 2x2", "olmoe 2x2 tie", "olmoe pod 2x1x2 drops"):
            c = r["cases"][case]["counts"]
            assert c["moe_cap"] == c["moe_cap_out"] == c["moe_cap.grad"] \
                == c["moe_cap_out.grad"] == layers, case
        assert "moe_cap" not in r["cases"]["olmoe 1x4"]["counts"]
        # TP inside each expert: one (T, d) sum after the gates forward,
        # and backward the experts' input and the gates summed
        t = r["cases"]["olmoe 2x2 tie"]["counts"]
        assert t["moe_out"] == t["moe_in.grad"] == t["moe_gate.grad"] \
            == t["moe_counts"] == layers
        assert "moe_out.grad" not in t
        s = r["cases"]["olmoe 2x2 tie sp"]["counts"]
        assert s["moe_seq"] == s["moe_out.grad"] == s["moe_gate.grad"] \
            == layers and "moe_seq.grad" not in s


@pytest.mark.parametrize("case", COUNTED)
def test_dryrun_counts_what_a_rank_issues(spawned, case):
    """Each rank's real CPU step under ``Counter`` equals ``Session.lower``
    of the same step as that rank on meta (a "cpu" session over a fake
    group of the mesh's ranks, in this process): FLOPs, bytes and the
    collectives by label (count, bytes, axis), exactly. On the pod
    meshes the gradient sums run over pod x data (``"dp_grads"`` on the
    data-parallel axis) and ZeRO-1's assembly over "data"."""
    import torch.distributed as dist
    from repro_torch.api import Session
    from repro_torch.configs.base import ShapeConfig
    ranks, _ = spawned
    kw = _jax_ref(_ref_key(case))[0]
    tokens = _batch(CASES[case][0], CASES[case][4])["tokens"]
    shape = ShapeConfig("case", tokens.shape[1], tokens.shape[0], "train")
    for r in ranks:
        real = r["counted"][case]
        _, lowered = Session(ModelConfig(**kw),
                             strategy=Strategy(**_strategy_kw(case)),
                             device="cpu", mesh=_axes(case)).lower(
            shape, rank=real["rank"])
        meta = lowered.counter
        assert not dist.is_initialized()
        assert meta.flops == real["flops"] > 0
        assert meta.bytes == real["bytes"] > 0
        assert meta.collectives == real["collectives"], case
        assert meta.kernels == real["kernels"] == {}
        if len(CASES[case][1]) == 3:
            assert real["collectives"]["dp_grads"]["axis"] == tp.BATCH
            if CASES[case][1][1] > 1:
                assert real["collectives"]["zero_params"]["axis"] == "data"
        if CASES[case][0] == "olmoe-1b-7b":
            for what in ("moe_cap", "moe_cap_out", "moe_counts"):
                assert real["collectives"][what]["axis"] == tp.BATCH


# ----------------------------------------- Session, launcher, checkpoints

#: the strategies of the olmoe smoke's checkpoint runs on the ranks: TP
#: inside each expert writes it, experts over "model" restore it
TIE_SESSION_ST = Strategy(remat=True, expert_parallel=False, dtype="float32")
EP_SESSION_ST = Strategy(remat=True, dtype="float32")


def test_session_train_tp2_dp2_checkpoint_restores(spawned):
    """``Session.train(tp=2, dp=2)``: two steps with finite losses equal
    on every rank; its checkpoint holds the full tree (written by the
    first rank), which a one-device trainer restores leaf for leaf and
    which equals the ranks' blocks; a (2, 2) trainer with other params
    restores its blocks of it (AdamW's master rebuilt from them). The
    olmoe smoke trained so with TP inside each expert for one step writes
    the full tree too (every expert whole, each expert's d_ff assembled
    over "model"): each rank's blocks are its TP-in-expert blocks of the
    saved leaves, and a (2, 2) trainer with the experts over "model", on
    other params, restores its expert-parallel blocks of the same
    leaves."""
    from repro_torch.api import Session
    from repro_torch.checkpoint import latest_step, load_checkpoint
    from repro_torch.configs import get_smoke
    from repro_torch.params import init_params
    from repro_torch.train.trainer import TrainConfig
    ranks, tmp = spawned
    hists = [[{k: v for k, v in h.items() if k != "wall"}
              for h in r["session"]["history"]] for r in ranks]
    assert [h["step"] for h in hists[0]] == [1, 2]
    assert all(h == hists[0] for h in hists)
    assert all(np.isfinite(h["loss"]) for h in hists[0])
    assert latest_step(tmp) == 2
    kw, _ = _jax_ref(_ref_key("qwen 2x2"))[:2]
    cfg = ModelConfig(**kw).with_(num_layers=2)
    st = Strategy(remat=True, dtype="float32")
    one = Session(cfg, strategy=st, device="cpu", seed=5).train(
        TrainConfig(steps=2, checkpoint_dir=tmp), global_batch=4,
        seq_len=16, restore=True)
    assert one.step == 2
    saved = flatten(load_checkpoint(tmp, 2, one.params))
    axes = {"data": 2, "model": 2}
    leaves = tp.leaf_blocks(ranks[0]["session"]["full_shapes"], st, axes,
                            cfg)
    for key, p in flatten(one.params).items():
        assert torch.equal(p, saved[key]), key
        for i, r in enumerate(ranks):
            coord = {"data": i // 2, "model": i % 2}
            want = tp.shard_leaf(p, leaves[key].spec, axes, coord).numpy()
            assert np.array_equal(r["session"]["blocks"][key], want), key
            assert np.array_equal(r["session"]["restored"][key], want), key
    for r in ranks:
        assert r["session"]["restored_step"] == 2
    # the sharded run trained what the one-device run trains
    fresh = Session(cfg, strategy=st, device="cpu", seed=3)
    trained = fresh.train(TrainConfig(steps=2, lr=LR, log_every=1, seed=3),
                          global_batch=4, seq_len=16)
    hist = trained.run()["history"]
    for a, b in zip(hist, hists[0]):
        assert a["loss"] == pytest.approx(b["loss"], abs=LOSS_TOL)
    for key, p in flatten(fresh.params).items():
        np.testing.assert_allclose(saved[key].numpy(),
                                   p.detach().numpy(), atol=PARAM_TOL,
                                   rtol=PARAM_TOL, err_msg=key)
    # the olmoe smoke with TP inside each expert: its checkpoint, restored
    # under expert parallelism
    moe = get_smoke("olmoe-1b-7b").with_(dtype="float32")
    d = f"{tmp}/olmoe_tie"
    assert latest_step(d) == 1
    saved = flatten(load_checkpoint(d, 1, init_params(moe, device="cpu")))
    views = {name: tp.leaf_blocks(full_shapes(moe), layout, axes, moe)
             for name, layout in (("tie", TIE_SESSION_ST),
                                  ("ep", EP_SESSION_ST))}
    w_up = "layers/moe/w_up"
    assert views["tie"][w_up].spec != views["ep"][w_up].spec
    for i, r in enumerate(ranks):
        coord = {"data": i // 2, "model": i % 2}
        got = r["tie_checkpoint"]
        assert got["tie_step"] == got["ep_step"] == 1
        for name in ("tie", "ep"):
            for key, full in saved.items():
                want = tp.shard_leaf(full, views[name][key].spec, axes,
                                     coord).numpy()
                assert np.array_equal(got[name][key], want), (name, key)
        # every expert at half its d_ff on the TP-in-expert rank
        assert got["tie"][w_up].shape == (2, 4, 128, 32)
        assert got["ep"][w_up].shape == (2, 2, 128, 64)


def test_train_launcher_dp2_tp2_fsdp_runs_on_ranks(spawned):
    """``launch/train.py --dp 2 --tp 2 --fsdp`` on the four ranks: two
    steps, the same finite loss on every rank."""
    ranks, _ = spawned
    outs = [[{k: v for k, v in h.items() if k != "wall"}
             for h in r["launcher"]["history"]] for r in ranks]
    assert outs[0][-1]["step"] == 2 and np.isfinite(outs[0][-1]["loss"])
    assert all(o == outs[0] for o in outs)


# ------------------------------------------- the SSM family, the hybrid

#: arch -> the case whose JAX init the checkpoint test takes
SSM_CHECKPOINTS = {"mamba2-780m": "mamba 2x2", "zamba2-1.2b": "zamba 2x2"}


def test_ssm_collectives_by_label(spawned):
    """A Mamba layer's collectives in a training step at (2, 2): one
    ``ssm_out`` and one ``ssm_norm`` sum forward; backward the norm's sum
    again (``ssm_norm.grad``), the block input's (``ssm_in.grad``) and
    the replicated B/C columns' of ``in_proj``, ``conv_w`` and ``conv_b``
    (``ssm_bc.grad``, three); under sequence parallelism the gather
    before ``in_proj`` and the reduce-scatter's backward a layer."""
    ranks, _ = spawned
    layers = 2
    for r in ranks:
        c = r["cases"]["mamba 2x2"]["counts"]
        assert c["ssm_out"] == c["ssm_norm"] == layers
        assert c["ssm_norm.grad"] == c["ssm_in.grad"] == layers
        assert c["ssm_bc.grad"] == 3 * layers
        assert "ssm_out.grad" not in c
        s = r["cases"]["mamba 2x2 sp"]["counts"]
        assert s["ssm_seq"] == s["ssm_out.grad"] == layers
        assert s["head_seq"] == 1 and s["embed.grad"] == 1
        z = r["cases"]["zamba 2x2"]["counts"]
        assert z["ssm_out"] == z["ssm_norm"] == 2
        assert z["attn_out"] == z["mlp_out"] == 1


def test_ssm_rank_holds_whole_heads(spawned):
    """Each rank's ``in_proj`` block is ``[z_r | x_r | B | C | dt_r]`` of
    the full leaf (din / tp columns of z and x, H / tp of dt, all of B
    and C) and its conv ``[x_r | B | C]``: at (1, 4) the smoke's 548
    columns give 161 a rank (64 + 64 + 16 + 16 + 1) where the table's
    contiguous split gives 137, its 288 conv channels 96 (64 + 16 + 16)
    where the table gives 72."""
    ranks, _ = spawned
    for r in ranks:
        run = r["cases"]["mamba 1x4"]
        assert run["params"][0]["layers/mamba/in_proj"].shape == (2, 128,
                                                                  161)
        assert run["params"][0]["layers/mamba/conv_w"].shape == (2, 4, 96)


def test_ssm_checkpoint_from_a_mesh_is_the_full_tree(spawned):
    """A (2, 2) FSDP trainer of the mamba2 and zamba2 smokes, handed the
    JAX init, writes a checkpoint equal to that init leaf for leaf (B/C
    from one rank, z/x/dt in rank order); a (2, 2) trainer on other
    params restores its blocks of it."""
    from repro_torch.checkpoint import latest_step, load_checkpoint
    from repro_torch.params import init_params
    ranks, tmp = spawned
    st = Strategy(fsdp=True, remat=False, dtype="float32")
    axes = {"data": 2, "model": 2}
    for arch, case in SSM_CHECKPOINTS.items():
        kw, flat, _ = _jax_ref(_ref_key(case))
        cfg = ModelConfig(**kw)
        d = f"{tmp}/{arch}"
        assert latest_step(d) == 0
        saved = flatten(load_checkpoint(d, 0, init_params(cfg, device="cpu")))
        assert set(saved) == set(flat)
        leaves = tp.leaf_blocks(full_shapes(cfg), st, axes, cfg)
        for key, want in flat.items():
            assert np.array_equal(saved[key].numpy(), want), key
            for i, r in enumerate(ranks):
                coord = {"data": i // 2, "model": i % 2}
                assert np.array_equal(r["ssm_checkpoint"][arch][key],
                                      _block(want, leaves[key].spec, case,
                                             coord)), key


def test_ssm_train_launcher_runs_on_ranks(spawned):
    """``launch/train.py --arch mamba2-780m --dp 2 --tp 2 --fsdp
    --seq-parallel`` on the four ranks: two steps, the same finite loss
    on every rank."""
    ranks, _ = spawned
    outs = [[{k: v for k, v in h.items() if k != "wall"}
             for h in r["ssm_launcher"]["history"]] for r in ranks]
    assert outs[0][-1]["step"] == 2 and np.isfinite(outs[0][-1]["loss"])
    assert all(o == outs[0] for o in outs)


# --------------------------------------------------------- the enc-dec family

#: the strategy of the enc-dec Session run on the ranks
ENCDEC_SESSION_ST = Strategy(remat=True, seq_parallel=True, dtype="float32")


def test_encdec_collectives_by_label(spawned):
    """A whisper step's collectives at (2, 2): an ``attn_out`` sum an
    encoder layer and two a decoder layer (self and cross), an
    ``mlp_out`` a layer of both; backward the ``attn_in`` and ``mlp_in``
    sums a layer, the cross query's ``xattn_in`` and ``enc_out``'s
    ``cross_in`` a decoder layer; under sequence parallelism the gathers
    before each column-parallel region (``enc_out`` gathered once), the
    reduce-scatters' backward, and the norms' scales summed."""
    ranks, _ = spawned
    kw = _jax_ref(_ref_key("whisper 2x2"))[0]
    enc, dec = kw["encoder_layers"], kw["num_layers"]
    for r in ranks:
        c = r["cases"]["whisper 2x2"]["counts"]
        assert c["attn_out"] == enc + 2 * dec and c["mlp_out"] == enc + dec
        assert c["attn_in.grad"] == c["mlp_in.grad"] == enc + dec
        assert c["xattn_in.grad"] == c["cross_in.grad"] == dec
        assert c["embed"] == c["logits"] == 1
        assert c["dp_grads"] == len(_leaves("whisper 2x2")[1])
        s = r["cases"]["whisper 2x2 sp"]["counts"]
        assert s["attn_seq"] == s["mlp_seq"] == enc + dec
        assert s["xattn_seq"] == s["cross_in.grad"] == dec
        assert s["enc_seq"] == s["head_seq"] == 1 and s["embed.grad"] == 1
        assert s["attn_out.grad"] == enc + 2 * dec
        assert s["mlp_out.grad"] == enc + dec
        assert s["norm.grad"] == 2 * enc + 3 * dec + 2
        f = r["cases"]["whisper 2x2 fsdp sp remat"]["counts"]
        assert "dp_grads" not in f
        assert f["fsdp_gather"] > f["fsdp_gather.grad"] > 0   # recompute
        k = r["cases"]["whisper 1x4"]["counts"]
        assert k["cross_in.grad"] == dec and "dp_grads" not in k


def test_encdec_train_launcher_and_session_on_ranks(spawned):
    """``launch/train.py --arch whisper-tiny --dp 2 --tp 2
    --seq-parallel`` and ``Session.train(tp=2, dp=2)`` on ``FramesData``:
    two steps, the same finite losses on every rank; the Session's
    checkpoint at step 2 holds the full tree, which a one-device trainer
    restores leaf for leaf and which equals each rank's blocks; the
    sharded run's losses and params those of the one-device run."""
    from repro_torch.api import Session
    from repro_torch.checkpoint import latest_step, load_checkpoint
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import FramesData
    from repro_torch.train.trainer import TrainConfig
    ranks, tmp = spawned
    for key in ("encdec_launcher", "encdec_session"):
        outs = [[{k: v for k, v in h.items() if k != "wall"}
                 for h in r[key]["history"]] for r in ranks]
        assert outs[0][-1]["step"] == 2, key
        assert all(np.isfinite(h["loss"]) for h in outs[0]), key
        assert all(o == outs[0] for o in outs), key
    assert [h["step"] for h in ranks[0]["encdec_session"]["history"]] == \
        [1, 2]
    d = f"{tmp}/whisper"
    assert latest_step(d) == 2
    cfg = get_smoke("whisper-tiny").with_(dtype="float32")

    def data():
        return FramesData(cfg, global_batch=4, seq_len=16, seed=3)
    one = Session(cfg, strategy=ENCDEC_SESSION_ST, device="cpu",
                  seed=5).train(TrainConfig(steps=2, checkpoint_dir=d),
                                data=data(), global_batch=4, seq_len=16,
                                restore=True)
    assert one.step == 2
    saved = flatten(load_checkpoint(d, 2, one.params))
    axes = {"data": 2, "model": 2}
    leaves = tp.leaf_blocks(full_shapes(cfg), ENCDEC_SESSION_ST, axes, cfg)
    for key, p in flatten(one.params).items():
        assert torch.equal(p, saved[key]), key
        for i, r in enumerate(ranks):
            coord = {"data": i // 2, "model": i % 2}
            want = tp.shard_leaf(p, leaves[key].spec, axes, coord).numpy()
            assert np.array_equal(r["encdec_session"]["blocks"][key],
                                  want), key
    fresh = Session(cfg, strategy=ENCDEC_SESSION_ST, device="cpu", seed=3)
    hist = fresh.train(TrainConfig(steps=2, lr=LR, log_every=1, seed=3),
                       data=data(), global_batch=4,
                       seq_len=16).run()["history"]
    for a, b in zip(hist, ranks[0]["encdec_session"]["history"]):
        assert a["loss"] == pytest.approx(b["loss"], abs=LOSS_TOL)
    for key, p in flatten(fresh.params).items():
        np.testing.assert_allclose(saved[key].numpy(), p.detach().numpy(),
                                   atol=PARAM_TOL, rtol=PARAM_TOL,
                                   err_msg=key)


def test_encdec_flash_limits_at_a_rank():
    """On a CUDA device (no card needed to refuse) the trainer checks the
    flash kernel at a rank's heads: whisper-tiny's 3 of 6 query and K/V
    heads x 64 a tp 2 rank pass, and so do they at D 64 unsharded; at a
    head dim the kernel does not take (D 20) the rank's check refuses."""
    from repro_torch.configs import get_config
    from repro_torch.train.trainer import check_kernel_limits
    cfg = get_config("whisper-tiny")
    rank = tp.Rank(tp=2, rank=0, group=None, root=0, heads=3, kv_heads=3,
                   kv_read=None)
    check_kernel_limits(cfg, Strategy(), "cuda", rank)
    check_kernel_limits(cfg, Strategy(), "cuda")
    with pytest.raises(ValueError, match="flash-attention kernel"):
        check_kernel_limits(cfg.with_(head_dim=20), Strategy(), "cuda", rank)


# ------------------------------------------------------------------ the VLM

def test_vlm_collectives_by_label(spawned):
    """A VLM step's collectives at (2, 2), the smoke's one group (2 self
    layers and 1 cross layer): an ``attn_out`` and an ``mlp_out`` sum a
    self and a cross layer forward; backward ``attn_in`` a self layer,
    the cross query's ``xattn_in`` and ``mlp_in`` a layer of both. The
    images are data: no ``cross_in`` gradient sum. Without sequence
    parallelism the gates' outputs are whole on every rank: no ``gate``
    sum; under it each of the two gates scales the rank's slice and its
    gradient is summed (``gate.grad``, two a cross layer), beside the
    norms' scales, the gathers before each column-parallel region and the
    reduce-scatters' backward. Under FSDP only the (G,) gates, which do
    not split over "data", take a "data" gradient sum. At (1, 4) the
    whole ``wk`` / ``wv`` of every self and cross layer sum their
    gradients (``kv_proj``)."""
    ranks, _ = spawned
    kw = _jax_ref(_ref_key("vlm 2x2"))[0]
    cfg = ModelConfig(**kw)
    g, rest = cfg.vlm_groups
    selfs, cross = g * cfg.cross_attn_every + rest, g
    for r in ranks:
        c = r["cases"]["vlm 2x2"]["counts"]
        assert c["attn_out"] == c["mlp_out"] == selfs + cross
        assert c["attn_in.grad"] == selfs and c["xattn_in.grad"] == cross
        assert c["mlp_in.grad"] == selfs + cross
        assert c["embed"] == c["logits"] == 1
        assert c["dp_grads"] == len(_leaves("vlm 2x2")[1])
        assert not {"gate.grad", "cross_in.grad", "kv_proj.grad"} & set(c)
        s = r["cases"]["vlm 2x2 sp"]["counts"]
        assert s["gate.grad"] == 2 * cross
        assert s["attn_seq"] == selfs and s["xattn_seq"] == cross
        assert s["mlp_seq"] == selfs + cross
        assert s["attn_out.grad"] == s["mlp_out.grad"] == selfs + cross
        assert s["norm.grad"] == 2 * (selfs + cross) + 1
        assert s["head_seq"] == 1 and s["embed.grad"] == 1
        assert "cross_in.grad" not in s
        f = r["cases"]["vlm 2x2 fsdp sp remat"]["counts"]
        assert f["gate.grad"] == 2 * cross
        # FSDP's gathers sum the gradient of each leaf they split; the
        # (G,) gates do not split over "data" and take the "data" sum
        whole = [k for k, lb in _leaves("vlm 2x2 fsdp sp remat")[1].items()
                 if lb.fsdp_dim is None]
        assert whole and all("gate" in k for k in whole)
        assert f["dp_grads"] == len(whole)
        assert f["fsdp_gather"] > f["fsdp_gather.grad"] > 0   # recompute
        k = r["cases"]["vlm 1x4"]["counts"]
        assert k["kv_proj.grad"] == 2 * (selfs + cross)
        assert not {"gate.grad", "cross_in.grad", "dp_grads"} & set(k)


def test_vlm_train_launcher_runs_on_ranks(spawned):
    """``launch/train.py --arch llama-3.2-vision-90b --dp 2 --tp 2
    --seq-parallel`` on the four ranks (``ImagesData``: every rank draws
    the same images and takes its rows): two steps, the same finite loss
    on every rank."""
    ranks, _ = spawned
    outs = [[{k: v for k, v in h.items() if k != "wall"}
             for h in r["vlm_launcher"]["history"]] for r in ranks]
    assert outs[0][-1]["step"] == 2 and np.isfinite(outs[0][-1]["loss"])
    assert all(o == outs[0] for o in outs)


# --------------------------------------------- planner Plans, executed

@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_session_trains_as_the_jax_plan(spawned, name):
    """``Session.from_plan`` of the "dp" search's plan (dp 2 x tp 2 with
    sequence parallelism: the reference's plan on H100's fields, field
    for field) and of a (1, 2, 2) pipe plan on the four ranks: the
    plan's strategy and mesh; two steps' losses within 1e-4 of JAX's
    ``Session.from_plan(..., devices=4)`` on the same init and every
    block within 5e-4 of JAX's trained params at the rank's coordinate
    (the reference test's bounds), equal on every rank; on the pipe
    mesh the two "pipe" replicas' blocks equal bit for bit, one
    checkpoint of the full tree (the first rank's) whose blocks are the
    ranks', and ``serve()`` refused naming pp."""
    from repro_torch.checkpoint import latest_step, load_checkpoint
    from repro_torch.params import init_params
    ranks, tmp = spawned
    row, _, losses, trained = _jax_plan_ref(name)
    cfg = ModelConfig(**PLAN_KW)
    recs = [r["plan"][name] for r in ranks]
    want_axes = {"data": 2, "model": 2} if name == "dp" else \
        {"data": 1, "pipe": 2, "model": 2}
    st = Strategy(**recs[0]["strategy"])
    assert st.seq_parallel == (name == "dp") and not st.remat
    assert st.microbatches == 1 and st.dtype == "float32"
    if name == "dp":
        assert row["degrees"] == dict(row["degrees"], dp=2, tp=2, pp=1,
                                      seq_parallel=True)
        assert st.name == "plan/dp"
    leaves = tp.leaf_blocks(full_shapes(cfg), st, want_axes, cfg)
    by_coord = {}
    for rec in recs:
        assert rec["row"] == row and rec["axes"] == want_axes
        assert rec["strategy"] == recs[0]["strategy"]
        np.testing.assert_allclose(rec["losses"], losses, atol=LOSS_TOL,
                                   rtol=0)
        assert rec["losses"] == recs[0]["losses"]
        for key, block in rec["blocks"].items():
            want = tp.shard_leaf(torch.from_numpy(trained[key]),
                                 leaves[key].spec, want_axes, rec["coord"])
            np.testing.assert_allclose(block, want.numpy(), atol=PARAM_TOL,
                                       rtol=PARAM_TOL, err_msg=key)
        place = (rec["coord"]["data"], rec["coord"]["model"])
        by_coord.setdefault(place, []).append(rec["blocks"])
    if name == "dp":
        assert all(len(v) == 1 for v in by_coord.values())
        return
    for a, b in by_coord.values():
        assert all(np.array_equal(a[k], b[k]) for k in a)
    d = f"{tmp}/plan_pipe"
    assert latest_step(d) == 2
    saved = flatten(load_checkpoint(d, 2, init_params(cfg, device="cpu")))
    for rec in recs:
        for key, block in rec["blocks"].items():
            want = tp.shard_leaf(saved[key], leaves[key].spec, want_axes,
                                 rec["coord"])
            assert np.array_equal(block, want.numpy()), key
        assert "pp=2" in rec["serve"] and "tp=/dp=" in rec["serve"]
