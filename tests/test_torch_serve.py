"""The port's serving stack on the CPU (repro_torch/{serve,api,launch}).

The paged mixed-step engine is held to the JAX ``ServeEngine(paged=True,
mixed=True)``: identical greedy token streams on the same weights and
prompts (tests/test_serve_mixed.py:86). Plus the engine's own contracts
(max_new=1, decode never stalled by a long prefill, bounded program
shapes), the not-yet-ported features raising, the Session and launcher
on ``device="cpu"``, the rule that the port imports no JAX, and
chip_smoke.py refusing to run without a card or without the repo.
"""
import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint.io import _flatten  # noqa: E402
from repro.configs.base import ModelConfig as JaxConfig  # noqa: E402
from repro.models import get_model  # noqa: E402
from repro.serve.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.api import Session  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.params import from_numpy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KW = dict(name="mixed-dense", arch_type="dense", num_layers=2, d_model=64,
          num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
          dtype="float32")
CFG = ModelConfig(**KW)


@pytest.fixture(scope="module")
def weights():
    """JAX-initialised params and their bridge into the port (CPU)."""
    jcfg = JaxConfig(**KW)
    jparams = get_model(jcfg).init(jax.random.key(0), jcfg)
    return jcfg, jparams, from_numpy(_flatten(jparams), CFG, "cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=(int(n),)).astype(np.int32)
            for n in lens]


def _serve(params, prompts, new, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("chunk_tokens", 16)
    eng = ServeEngine(CFG, params, **kw)
    for i, p in enumerate(prompts):
        eng.submit(i, p, max_new=new)
    res = eng.run()
    return {i: list(res[i].out) for i in res}, eng


def test_greedy_streams_match_jax_mixed_engine(weights):
    jcfg, jparams, params = weights
    prompts = _prompts(0, (5, 23, 9, 40, 6))
    jeng = JaxEngine(jcfg, jparams, slots=2, max_len=64, paged=True,
                     mixed=True, chunk_tokens=16)
    for i, p in enumerate(prompts):
        jeng.submit(i, p, max_new=6)
    jres = jeng.run()
    want = {i: list(jres[i].out) for i in jres}
    got, eng = _serve(params, prompts, 6)
    assert got == want
    assert all(r.done for r in eng.finished.values())
    for key in ("prefills", "decode_tokens", "prefill_chunk_tokens",
                "decode_steps", "decode_slot_steps", "peak_pages",
                "decode_traces", "prefill_traces"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["decode_backend"] == "plain"
    assert eng.stats["mixed_steps"] >= eng.stats["decode_steps"]
    # pages are all returned; the tracer saw every request complete
    assert eng.stats["pages_in_use"] == 0
    assert len(eng.trace()["traceEvents"]) > 0


def test_max_new_one_finishes_on_the_prefill_token(weights):
    _, _, params = weights
    prompts = _prompts(1, (7, 30, 3))
    out, eng = _serve(params, prompts, 1)
    assert all(len(v) == 1 for v in out.values())
    longer, _ = _serve(params, prompts, 4)
    assert all(longer[i][:1] == out[i] for i in out)
    assert eng.stats["decode_steps"] == 0 and eng.stats["prefills"] == 3


def test_long_prefill_never_stalls_decode(weights):
    """tests/test_serve_mixed.py:166 on the port: while a 40-token prompt
    prefills through an 8-token budget, the decoding slot gains one token
    every step, and the streams equal an uninterleaved run."""
    _, _, params = weights
    short, long = _prompts(11, (4, 40))
    eng = ServeEngine(CFG, params, slots=2, max_len=64, chunk_tokens=8)
    eng.submit(0, short, max_new=12)
    eng.step()
    eng.submit(1, long, max_new=4)
    chunk_steps = 0
    while eng.busy():
        before = len(eng.active[0].out) if eng.active[0] is not None else None
        pf = eng.stats["prefill_chunk_tokens"]
        eng.step()
        if eng.stats["prefill_chunk_tokens"] > pf:
            chunk_steps += 1
            if before is not None and eng.active[0] is not None:
                assert len(eng.active[0].out) == before + 1
    assert chunk_steps >= 5
    res = eng.results()
    ref, _ = _serve(params, [short, long], 12, chunk_tokens=8)
    assert list(res[0].out) == ref[0]
    solo, _ = _serve(params, [long], 4, chunk_tokens=8)
    assert list(res[1].out) == solo[0]


def test_program_shapes_bounded_by_page_buckets(weights):
    """tests/test_serve_mixed.py:208: ten prompt lengths, one token
    budget — the distinct program shapes stay <= 3 on this pool."""
    _, _, params = weights
    prompts = _prompts(13, (4, 6, 9, 12, 17, 21, 26, 33, 40, 47))
    out, eng = _serve(params, prompts, 4, slots=3)
    assert eng.stats["decode_traces"] <= 3
    assert eng.stats["prefill_traces"] == 0
    assert all(len(v) == 4 for v in out.values())


def test_sampling_greedy_ties_and_seeded_temperature(weights):
    """Greedy is the reference's argmax (first maximum wins); temperature
    draws follow softmax(logits / T) and replay from the same seed, in
    the sampler and through the engine."""
    from repro.serve.sampling import sample_tokens as jax_sample
    from repro_torch.serve.sampling import sample_tokens
    logits = np.array([[0.0, 3.0, 3.0, 1.0], [2.0, 2.0, 2.0, 2.0],
                       [-1.0, -5.0, 0.5, 0.25]], np.float32)
    greedy = sample_tokens(torch.from_numpy(logits))
    assert greedy.dtype == torch.int32
    assert greedy.tolist() == np.asarray(jax_sample(logits)).tolist() \
        == [1, 0, 2]
    row = torch.tensor([[0.0, 1.0, 2.0, -1.0]]).expand(4000, 4)
    gen = torch.Generator().manual_seed(5)
    draws = sample_tokens(row, generator=gen, temperature=2.0)
    freq = np.bincount(draws.numpy(), minlength=4) / 4000
    want = torch.softmax(row[0] / 2.0, dim=-1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.03)
    again = sample_tokens(row, generator=torch.Generator().manual_seed(5),
                          temperature=2.0)
    assert torch.equal(draws, again)
    _, _, params = weights
    prompts = _prompts(2, (5, 9, 14))
    a, _ = _serve(params, prompts, 5, temperature=1.0, seed=1)
    b, _ = _serve(params, prompts, 5, temperature=1.0, seed=1)
    assert a == b and all(len(v) == 5 for v in a.values())


def test_step_helpers_match_reference():
    """The port's copies of serve/step.py's host helpers give the JAX
    package's answers on seeded random inputs."""
    from repro.serve import step as jstep
    from repro_torch.serve import step
    rng = np.random.default_rng(7)
    for n in range(1, 300, 7):
        cap = int(rng.integers(0, 512))
        assert step.prefill_bucket(n, cap=cap) == \
            jstep.prefill_bucket(n, cap=cap)
        assert step.page_bucket(n, cap=max(cap, 1)) == \
            jstep.page_bucket(n, cap=max(cap, 1))
    for _ in range(200):
        budget = int(rng.integers(4, 64))
        decode = int(rng.integers(0, 5))
        items = []
        for s in range(int(rng.integers(0, 5))):
            n = int(rng.integers(1, 80))
            items.append({"slot": s, "n": n,
                          "cursor": int(rng.integers(0, n))})
        assert step.pack_token_budget(budget, decode, items) == \
            jstep.pack_token_budget(budget, decode, items)


def test_submit_validation_and_backpressure(weights):
    _, _, params = weights
    eng = ServeEngine(CFG, params, slots=2, max_len=48, kv_pages=2,
                      chunk_tokens=16)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(0, np.zeros(0, np.int32), max_new=2)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(0, np.zeros(48, np.int32), max_new=2)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(0, np.ones(3, np.int32), max_new=0)
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit(0, np.ones(30, np.int32), max_new=40)
    # two requests of 2 pages each on a 2-page pool: the second waits
    for i, p in enumerate(_prompts(5, (10, 10))):
        eng.submit(i, p, max_new=10)
    eng.step()
    assert eng.active[1] is None and len(eng.queue) == 1
    res = eng.run()
    assert all(res[i].done and len(res[i].out) == 10 for i in (0, 1))
    with pytest.raises(ValueError, match="chunk_tokens"):
        ServeEngine(CFG, params, slots=4, chunk_tokens=2)


@pytest.mark.parametrize("kw,item", [
    ({"prefix_cache": True}, "5(b)"), ({"lazy": True}, "5(b)"),
    ({"mixed": False}, "5(d)"), ({"paged": False}, "5(d)"),
    ({"scheduler": object()}, "5(c)"), ({"spec": 2}, "item 7"),
    ({"mesh": object()}, "item 11")])
def test_unported_engine_features_raise(weights, kw, item):
    _, _, params = weights
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        ServeEngine(CFG, params, **kw)


def test_unported_requests_and_families_raise(weights):
    _, _, params = weights
    eng = ServeEngine(CFG, params)
    with pytest.raises(NotImplementedError, match="item 10"):
        eng.submit(0, np.ones(3, np.int32), max_new=2,
                   frames=np.zeros((2, 2), np.float32))
    with pytest.raises(NotImplementedError, match=r"5\(c\)"):
        eng.submit(0, np.ones(3, np.int32), max_new=2, deadline_s=1.0)
    moe = CFG.with_(arch_type="moe", num_experts=4, experts_per_token=2)
    with pytest.raises(NotImplementedError, match="item 10"):
        ServeEngine(moe, params)


def test_session_serves_on_cpu_and_keeps_reference_keywords(weights):
    _, _, params = weights
    session = Session(CFG, device="cpu", params=params)
    eng = session.serve(slots=2, max_len=64, chunk_tokens=16, seed=3)
    assert eng.device.type == "cpu"
    for i, p in enumerate(_prompts(0, (5, 23))):
        eng.submit(i, p, max_new=3)
    got = {i: list(r.out) for i, r in eng.run().items()}
    ref, _ = _serve(params, _prompts(0, (5, 23)), 3)
    assert got == ref
    with pytest.raises(NotImplementedError, match="item 11"):
        session.serve(tp=2)
    with pytest.raises(ValueError, match="attn_backend"):
        session.serve(attn_backend="gather")
    fresh = Session(CFG, device="cpu", seed=7)
    assert fresh.params["embed"].device.type == "cpu"


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve as launcher
    results = launcher.main(["--device", "cpu", "--requests", "3",
                             "--max-new", "3", "--trace-level", "0"])
    assert len(results) == 3 and all(r.done for r in results.values())
    assert "plain path" in capsys.readouterr().out


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; import repro_torch, "
            "repro_torch.api, repro_torch.launch.serve, "
            "repro_torch.kernels.build; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "is_available" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _smoke(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
