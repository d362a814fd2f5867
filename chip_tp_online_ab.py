"""Where the online driver's step time goes over tensor-parallel ranks:
Qwen3-14B at full width, tp 2, on two gloo rank processes sharing one
card (``chip_smoke.py`` phases 19 and 26's setting, phase 5's six
prompts, 16 new tokens), served in turns by the lockstep loop on the
main thread (L), the online ``AsyncDriver`` with a deferred start (O)
and the lockstep loop on a background thread (T), in the order
L O T T O L, all on the same rank shards. Prints each run's engine step
p50 and wall time on rank 0, the driver's control channel a pass, and
whether the streams equal the first L run's; writes
``chiprun_out/tp_online_ab.json``.

    python3 chip_tp_online_ab.py        # on a machine with one H100
"""
import gc
import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ORDER = ("L", "O", "T", "T", "O", "L")


def _rank(rank, world, seed, prompts, max_new):
    from repro_torch.api import Session
    from repro_torch.configs import get_config
    torch.cuda.set_device(0)
    cfg = get_config("qwen3-14b")
    session = Session(cfg, device="cuda", seed=seed)
    params = session.serve(tp=world, **cs.ONLINE_TP_KW).params
    session = Session(cfg, device="cuda", params=params)
    out = []
    for kind in ORDER:
        gc.collect()
        torch.cuda.empty_cache()
        if kind == "O":
            drv = session.serve_async(tp=world, start=False,
                                      **cs.ONLINE_TP_KW)
            live = [drv.submit(p, max_new=max_new, rid=i)
                    for i, p in enumerate(prompts)] if drv.lead else []
            t0 = time.perf_counter()
            drv.start()
            streams = [list(s.result(timeout=600).out) for s in live]
            drv.stop(timeout=600)
            wall = time.perf_counter() - t0
            p50 = drv.metrics.step_latency.quantile(0.5) * 1e3
            steps = drv.metrics.step_latency.count
            extra = {"passes": drv._chan.passes,
                     "channel_ms": drv._chan.seconds * 1e3}
            del drv
        else:
            eng = session.serve(tp=world, **cs.ONLINE_TP_KW)
            for i, p in enumerate(prompts):
                eng.submit(i, p, max_new=max_new)
            step_s = []

            def loop():
                while eng.busy():
                    s0 = time.perf_counter()
                    eng.step()
                    step_s.append(time.perf_counter() - s0)

            t0 = time.perf_counter()
            if kind == "L":
                loop()
            else:
                t = threading.Thread(target=loop)
                t.start()
                t.join()
            wall = time.perf_counter() - t0
            res = eng.results()
            streams = [list(res[i].out) for i in range(len(prompts))]
            p50 = float(np.percentile(np.asarray(step_s) * 1e3, 50))
            steps = len(step_s)
            extra = {}
            del eng
        out.append({"kind": kind, "p50_ms": p50, "steps": steps,
                    "wall_s": wall, "streams": streams, **extra})
    return out


if __name__ == "__main__":
    smi = cs.phase_card()
    cs.phase_build()
    from repro_torch.configs import get_config
    _, prompts = cs.serving_prompts(0, get_config("qwen3-14b").vocab_size)
    prompts = [np.asarray(p, np.int32) for p in prompts]
    ranks = cs._spawn_ranks(_rank, (0, prompts, 16), 600.0, "tp online a/b")
    r0 = ranks[0]
    base = r0[0]["streams"]
    for run in r0:
        cs.log(f"[tp online a/b] {run['kind']}: step p50 {run['p50_ms']:.1f} ms, "
               f"{run['steps']} steps, {run['wall_s']:.2f} s, streams equal "
               f"to the first L: {run['streams'] == base}"
               + (f", channel {run['channel_ms'] / run['passes']:.2f} ms a "
                  f"pass over {run['passes']}" if "passes" in run else "")
               + f" ({smi})")
    cs.log(f"[tp online a/b] children {cs.child_processes()}")
    (cs.ROOT / "chiprun_out").mkdir(exist_ok=True)
    (cs.ROOT / "chiprun_out" / "tp_online_ab.json").write_text(json.dumps(
        [{k: v for k, v in r.items() if k != "streams"} for r in r0]))
