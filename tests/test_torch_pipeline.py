"""GPipe pipeline parallelism in the port (core/pipeline.py,
launch/mesh.py::make_pipeline_mesh) against the JAX package's
``repro/core/pipeline.py`` — the twin of tests/test_pipeline.py.

One spawn (``launch/ranks.py``: four ``spawn``-started CPU gloo ranks, a
FileStore under ``tmp_path``, a timeout that kills the ranks) runs every
rank case on the same numpy inputs, made from a seed, that the JAX
package's ``pipeline_apply`` takes (each JAX reference is built once and
shared):

* the reference test's tanh stage (P 4, M 8, mb 2, d 16) on a (1, 4, 1)
  mesh: the output equals JAX's and the sequential loop's at atol = rtol
  = 1e-5;
* its gradient case (P 2, M 4, mb 2, d 8) on (2, 2, 1) and (1, 2, 2),
  and one stage (P 1) on (4, 1, 1):
  every rank's stage gradient equals ``jax.grad`` of the reference's
  ``pipeline_apply`` at atol 1e-5, rtol 1e-4 (the reference test's),
  the slices of other stages get none, the replicas over "data" /
  "model" agree bit for bit, and the stage function never sees the
  tensor-parallel rank the caller made current;
* a stage of two ``transformer.block``s of the qwen3 smoke config in
  float32 (8 layers over 4 stages): output and every stage's gradients
  against JAX's ``pipeline_apply`` over ``repro.models.transformer.block``;
* the pipe moves by label (``pipe_send``, ``pipe_send.grad``,
  ``pipe_out``), count and bytes, for one forward and one backward;
* ``make_pipeline_mesh``'s axes, shape and row-major rank order, and its
  refusal of a mesh larger than the process group.

``simulate_schedule`` is held to the reference's dict for every (p, m) of
tests/test_pipeline.py under both schedules. This module imports JAX and
the reference only in this process; the ranks import ``repro_torch``
only.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import pipeline as jpipe  # noqa: E402
from repro.launch.mesh import make_pipeline_mesh as jax_pipeline_mesh  # noqa: E402,E501
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.launch.ranks import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT = 180.0            # seconds the spawn may take before it fails
OUT_TOL = 1e-5                  # the reference test's output bound
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4       # and its gradient bounds

#: the tanh cases: (data, pipe, model) mesh, P, M, mb, d
TANH = {"p4 (1,4,1)": ((1, 4, 1), 4, 8, 2, 16),
        "p2 (2,2,1)": ((2, 2, 1), 2, 4, 2, 8),
        "p2 (1,2,2)": ((1, 2, 2), 2, 4, 2, 8),
        "p1 (4,1,1)": ((4, 1, 1), 1, 4, 2, 8)}
#: the transformer-block stage: qwen3 smoke in float32, P stages of
#: LAYERS / P layers, M microbatches of mb rows of S positions
BLOCK_MESH, BLOCK_LAYERS, BLOCK_M, BLOCK_MB, BLOCK_S = (1, 4, 1), 8, 4, 1, 16

_JAX = {}


def _tanh_inputs(case):
    _, p, m, mb, d = TANH[case]
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((p, d, d)) * 0.3).astype(np.float32)
    x = rng.standard_normal((m * mb, d)).astype(np.float32)
    return w, x


def _jax_tanh(case):
    """JAX's ``pipeline_apply`` output and ``jax.grad`` of its loss, and
    the sequential loop's, for tanh case ``case``; made once."""
    if case not in _JAX:
        shape, p, m, _, _ = TANH[case]
        w, x = _tanh_inputs(case)
        mesh = jax_pipeline_mesh(data=shape[0], pipe=shape[1],
                                 model=shape[2])

        def run(w):
            return jpipe.pipeline_apply(lambda pw, xx: jnp.tanh(xx @ pw), w,
                                        jnp.asarray(x), mesh=mesh,
                                        num_microbatches=m)

        def seq(w):
            y = jnp.asarray(x)
            for i in range(p):
                y = jnp.tanh(y @ w[i])
            return y

        def loss(w):
            y = run(w)
            return (y ** 2).mean(), y

        (_, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jnp.asarray(w))
        _JAX[case] = {"out": np.asarray(out), "grad": np.asarray(grad),
                      "seq_out": np.asarray(seq(jnp.asarray(w)))}
    return _JAX[case]


def _block_cfg_kw():
    from repro.configs import get_smoke
    return dict(get_smoke("qwen3-14b").with_(
        dtype="float32", num_layers=BLOCK_LAYERS).__dict__)


def _jax_block():
    """The transformer-block stage through JAX's ``pipeline_apply``: the
    stage tree (every layer leaf (P, L / P, ...)) and the input as numpy,
    the output and the gradients of ``(y ** 2).mean()`` by stage tree
    leaf; made once."""
    if "block" not in _JAX:
        from repro.checkpoint.io import _flatten
        from repro.configs.base import ModelConfig as JaxConfig
        from repro.models import get_model
        from repro.models.transformer import block
        cfg = JaxConfig(**_block_cfg_kw())
        p = BLOCK_MESH[1]
        per = BLOCK_LAYERS // p
        layers = get_model(cfg).init(jax.random.key(0), cfg)["layers"]
        stages = jax.tree.map(
            lambda a: a.reshape((p, per) + a.shape[1:]), layers)
        x = np.random.default_rng(1).standard_normal(
            (BLOCK_M * BLOCK_MB, BLOCK_S, cfg.d_model)).astype(np.float32)
        mesh = jax_pipeline_mesh(data=BLOCK_MESH[0], pipe=p,
                                 model=BLOCK_MESH[2])

        def stage_fn(local, h):
            for i in range(per):
                h, _ = block(jax.tree.map(lambda a: a[i], local), h, cfg)
            return h

        def run(stages):
            return jpipe.pipeline_apply(stage_fn, stages, jnp.asarray(x),
                                        mesh=mesh, num_microbatches=BLOCK_M)

        def loss(stages):
            y = run(stages)
            return (y ** 2).mean(), y

        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            stages)
        _JAX["block"] = {
            "stages": {k: np.asarray(v) for k, v in _flatten(stages).items()},
            "x": x, "out": np.asarray(out),
            "grads": {k: np.asarray(v) for k, v in _flatten(grads).items()}}
    return _JAX["block"]


# ----------------------------------------------------------- the ranks

def _run(mesh, stage_fn, params, x, m, *, rank_view=None):
    """One forward and backward of ``pipeline_apply`` on this rank (under
    ``rank_view``, a tensor-parallel rank made current by the caller):
    the output, the moves after the forward and after the backward, the
    stage index and whether the stage function ever saw a current rank."""
    from repro_torch.core import tp
    stage = tpipe.Stage.of(mesh)
    seen = []

    def fn(local, xx):
        seen.append(tp.current())
        return stage_fn(local, xx)

    with tp.active(rank_view):
        out = tpipe.pipeline_apply(fn, params, x, mesh=mesh,
                                   num_microbatches=m, stage=stage)
        fwd = (dict(stage.counts), dict(stage.bytes))
        (out ** 2).mean().backward()
    return {"out": out.detach().numpy().copy(), "stage": stage.index,
            "fwd": fwd, "moves": (dict(stage.counts), dict(stage.bytes)),
            "saw_rank": any(r is not None for r in seen),
            "calls": len(seen)}


def _tanh_rank(mesh, case, w, x):
    from repro_torch.configs import get_smoke
    from repro_torch.core import tp
    from repro_torch.core.pipeline import Stage
    m = TANH[case][2]
    view = tp.Rank.of(mesh, get_smoke("qwen3-14b")) \
        if mesh.size(2) > 1 else None
    wt = torch.from_numpy(w).requires_grad_()
    out = _run(mesh, lambda pw, xx: torch.tanh(xx @ pw), wt,
               torch.from_numpy(x), m, rank_view=view)
    i = Stage.of(mesh).index
    out["grad"] = wt.grad[i].numpy().copy()
    out["other_grads"] = float(torch.cat(
        [wt.grad[:i], wt.grad[i + 1:]]).abs().max()) if len(wt) > 1 else 0.0
    out["coord"] = {n: int(mesh[n].get_local_rank())
                    for n in mesh.mesh_dim_names}
    return out


def _block_rank(mesh, ref):
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.transformer import block, unstack
    from repro_torch.tree import flatten, unflatten
    cfg = ModelConfig(**_block_cfg_kw())
    per = BLOCK_LAYERS // BLOCK_MESH[1]
    flat = {k: torch.from_numpy(v).requires_grad_()
            for k, v in ref["stages"].items()}

    def stage_fn(local, h):
        for lp in unstack(local, per):
            h, _ = block(lp, h, cfg)
        return h

    out = _run(mesh, stage_fn, unflatten(dict(flat)),
               torch.from_numpy(ref["x"]), BLOCK_M)
    i = out["stage"]
    out["grads"] = {k: v.grad[i].numpy().copy() for k, v in flat.items()}
    out["other_grads"] = max(float(torch.cat(
        [v.grad[:i], v.grad[i + 1:]]).abs().max()) for v in flat.values())
    return out


def _mesh_rank():
    """``make_pipeline_mesh``'s layout on this rank, and its refusal of
    more ranks than the group has."""
    from repro_torch.launch.mesh import make_pipeline_mesh
    out = {}
    for shape in ((1, 4, 1), (2, 2, 1), (1, 2, 2), (4, 1, 1)):
        mesh = make_pipeline_mesh(data=shape[0], pipe=shape[1],
                                  model=shape[2], device_type="cpu")
        out[shape] = {"names": tuple(mesh.mesh_dim_names),
                      "shape": tuple(int(s) for s in mesh.shape),
                      "coord": tuple(int(mesh[n].get_local_rank())
                                     for n in mesh.mesh_dim_names)}
    try:
        make_pipeline_mesh(data=2, pipe=4, model=1, device_type="cpu")
    except ValueError as e:
        out["refused"] = str(e)
    return out


def _all_ranks(rank, world, refs):
    """Every case of this module on one rank: one spawn for all."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_pipeline_mesh
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_pipeline_mesh(
                data=shape[0], pipe=shape[1], model=shape[2],
                device_type="cpu")
        return meshes[shape]

    out = {"tanh": {case: _tanh_rank(mesh_of(TANH[case][0]), case, w, x)
                    for case, (w, x) in refs["tanh"].items()},
           "block": _block_rank(mesh_of(BLOCK_MESH), refs["block"]),
           "mesh": _mesh_rank()}
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank's results of every case, from one spawn."""
    refs = {"tanh": {case: _tanh_inputs(case) for case in TANH},
            "block": {k: _jax_block()[k] for k in ("stages", "x")}}
    return run_ranks(_all_ranks, 4, args=(refs,),
                     store_dir=str(tmp_path_factory.mktemp("store")),
                     timeout=RANK_TIMEOUT)


# ------------------------------------------------------------ the tests

def test_gpipe_matches_jax_and_sequential(spawned):
    """The reference test's case: every rank returns the whole output,
    equal to JAX's ``pipeline_apply`` and to the sequential loop."""
    case = "p4 (1,4,1)"
    ref = _jax_tanh(case)
    for r in spawned:
        got = r["tanh"][case]["out"]
        np.testing.assert_allclose(got, ref["out"], atol=OUT_TOL,
                                   rtol=OUT_TOL)
        np.testing.assert_allclose(got, ref["seq_out"], atol=OUT_TOL,
                                   rtol=OUT_TOL)


@pytest.mark.parametrize("case", sorted(TANH))
def test_gpipe_gradients_match_jax(spawned, case):
    """Each rank's stage gradient equals ``jax.grad`` of the reference's
    ``pipeline_apply`` at its stage's slice; the other slices get none;
    the replicas over "data" and "model" agree bit for bit; the stage
    function runs with no tensor-parallel rank current."""
    ref = _jax_tanh(case)
    by_stage = {}
    for r in spawned:
        got = r["tanh"][case]
        np.testing.assert_allclose(got["out"], ref["out"], atol=OUT_TOL,
                                   rtol=OUT_TOL)
        np.testing.assert_allclose(got["grad"], ref["grad"][got["stage"]],
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)
        assert got["other_grads"] == 0.0
        assert not got["saw_rank"]
        assert got["coord"]["pipe"] == got["stage"]
        first = by_stage.setdefault(got["stage"], got["grad"])
        np.testing.assert_array_equal(got["grad"], first)
    assert sorted(by_stage) == list(range(TANH[case][1]))


def test_block_stage_matches_jax(spawned):
    """Two qwen3 smoke blocks a stage (float32, 4 stages): the output and
    every stage's gradients equal JAX's ``pipeline_apply`` over
    ``repro.models.transformer.block``."""
    ref = _jax_block()
    seen = set()
    for r in spawned:
        got = r["block"]
        np.testing.assert_allclose(got["out"], ref["out"], atol=OUT_TOL,
                                   rtol=OUT_TOL)
        assert got["other_grads"] == 0.0
        i = got["stage"]
        seen.add(i)
        for key, g in got["grads"].items():
            np.testing.assert_allclose(g, ref["grads"][key][i],
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"stage {i} {key}")
    assert seen == set(range(BLOCK_MESH[1]))


def test_pipe_moves_by_label(spawned):
    """One forward moves a stage output each of the T = M + P - 1 ticks
    (``pipe_send``) and copies the M outputs once (``pipe_out``); one
    backward moves a gradient back each tick but the last, whose move no
    later tick reads (``pipe_send.grad``)."""
    for r in spawned:
        for case, (_, p, m, mb, d) in TANH.items():
            run = r["tanh"][case]
            ticks, move = m + p - 1, mb * d * 4
            assert run["calls"] == ticks
            assert run["fwd"] == ({"pipe_send": ticks, "pipe_out": 1},
                                  {"pipe_send": ticks * move,
                                   "pipe_out": m * move})
            counts, nbytes = run["moves"]
            assert counts == {"pipe_send": ticks, "pipe_out": 1,
                              "pipe_send.grad": ticks - 1}
            assert nbytes["pipe_send.grad"] == (ticks - 1) * move
        counts, nbytes = r["block"]["moves"]
        ticks = BLOCK_M + BLOCK_MESH[1] - 1
        move = BLOCK_MB * BLOCK_S * 256 * 4
        assert counts == {"pipe_send": ticks, "pipe_out": 1,
                          "pipe_send.grad": ticks - 1}
        assert nbytes == {"pipe_send": ticks * move,
                          "pipe_out": BLOCK_M * move,
                          "pipe_send.grad": (ticks - 1) * move}


def test_make_pipeline_mesh_layout(spawned):
    """("data", "pipe", "model") of the asked shape, ranks laid out
    row-major as the reference's mesh; a mesh of 8 ranks on a group of
    4 is refused."""
    for rank, r in enumerate(spawned):
        for shape, got in r["mesh"].items():
            if shape == "refused":
                continue
            assert got["names"] == ("data", "pipe", "model")
            assert got["shape"] == shape
            d, p, m = shape
            assert got["coord"] == (rank // (p * m), rank // m % p, rank % m)
        assert "needs 8 ranks" in r["mesh"]["refused"]
        assert "has 4" in r["mesh"]["refused"]


def test_make_pipeline_mesh_refuses_without_group():
    from repro_torch.launch.mesh import make_pipeline_mesh
    with pytest.raises(ValueError, match="no process group"):
        make_pipeline_mesh(data=1, pipe=2, model=1, device_type="cpu")


def test_pipeline_apply_refuses_ragged_microbatches():
    """B % M != 0 is refused before any rank is asked, as the reference's
    ``assert``."""
    with pytest.raises(ValueError, match="does not split into 4"):
        tpipe.pipeline_apply(lambda p, x: x, torch.zeros(2, 3, 3),
                             torch.zeros(6, 3), mesh=None,
                             num_microbatches=4)
    with pytest.raises(AssertionError):
        jpipe.pipeline_apply(lambda p, x: x, jnp.zeros((2, 3, 3)),
                             jnp.zeros((6, 3)), mesh=None,
                             num_microbatches=4)


#: every (p, m) of tests/test_pipeline.py
SCHEDULE_PM = sorted({(2, 4), (4, 8), (4, 32), (8, 64)}
                     | {(4, m) for m in (1, 2, 4, 8, 16, 64)})


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
@pytest.mark.parametrize("p,m", SCHEDULE_PM)
def test_simulate_schedule_matches_reference(p, m, schedule):
    kw = dict(schedule=schedule, fwd_time=1.0, bwd_time=2.0)
    assert tpipe.simulate_schedule(p, m, **kw) == \
        jpipe.simulate_schedule(p, m, **kw)
    assert tpipe.simulate_schedule(p, m, schedule=schedule) == \
        jpipe.simulate_schedule(p, m, schedule=schedule)


def test_simulate_schedule_refuses_unknown():
    with pytest.raises(ValueError, match="zb-h1"):
        tpipe.simulate_schedule(4, 8, schedule="zb-h1")
    with pytest.raises(ValueError, match="zb-h1"):
        jpipe.simulate_schedule(4, 8, schedule="zb-h1")


def test_pipeline_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.core.pipeline, repro_torch.launch.mesh; "
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
