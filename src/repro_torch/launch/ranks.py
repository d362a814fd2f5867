"""Run one function on ``world`` ranks of a fresh process group on this
host: one ``spawn``-started process a rank (as ``torchrun`` starts them),
meeting through a ``FileStore`` in a directory the caller names, so no
port is fixed and runs beside each other never meet.

    from repro_torch.launch.ranks import run_ranks
    outs = run_ranks(fn, 2, args=(cfg_kw,), store_dir=tmp, timeout=120)

``fn(rank, world, *args)`` runs in rank ``rank`` after
``torch.distributed.init_process_group(backend, ...)`` and its return
value comes back (pickled, over the rank's own pipe) in ``outs[rank]``.
``fn`` must be importable by its module's name (a top-level function),
and so must every argument. ``args`` reach the ranks through one pickle
file in the store's directory, read by each rank once it has started: a
``spawn`` start writes what it passes through a pipe that the new
process reads only after importing the caller's ``__main__``, so large
arguments passed that way would start the ranks one after another. The ranks talk over the loopback interface
(``GLOO_SOCKET_IFNAME=lo`` unless the caller's ``env`` says otherwise).
A rank that raises, dies or does not finish within ``timeout`` seconds
fails the run: the other ranks are killed — a collective one rank never
reaches cannot hang the caller — and ``RuntimeError`` (``TimeoutError``
on the timeout) carries the failing rank's traceback.

A call leaves no process behind: every rank is joined, and the
``multiprocessing`` resource tracker that starting a ``spawn`` process
launches is stopped and reaped when this call launched it (an
interpreter without the fix for CPython issue 88887 leaves it to outlive
its parent, as a zombie no one reaps).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import time
import traceback
import uuid
from multiprocessing import connection, resource_tracker
from typing import Callable, Dict, Optional, Sequence


def _rank_main(fn, rank: int, world: int, backend: str, store: str, out,
               args_path: str):
    import torch.distributed as dist
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        dist.init_process_group(backend, store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.send((True, result))
    except BaseException:                      # reported, then re-raised
        out.send((False, traceback.format_exc()))
        raise
    finally:
        out.close()


def run_ranks(fn: Callable, world: int, *, args: Sequence = (),
              backend: str = "gloo", store_dir: str,
              timeout: float = 120.0,
              env: Optional[Dict[str, str]] = None) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    in its own rank process (see the module docstring)."""
    ctx = mp.get_context("spawn")
    # no lock or queue: a pipe a rank registers nothing with the tracker,
    # so stopping it below cleans up nothing of anyone's
    tracker = resource_tracker._resource_tracker
    own_tracker = tracker._fd is None          # this call will launch it
    pipes = [ctx.Pipe(duplex=False) for _ in range(world)]
    run = uuid.uuid4().hex
    store = os.path.join(store_dir, f"store-{run}")
    args_path = os.path.join(store_dir, f"args-{run}.pkl")
    try:
        with open(args_path, "wb") as f:
            pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
    except BaseException:
        if os.path.exists(args_path):
            os.remove(args_path)
        raise
    env = {"GLOO_SOCKET_IFNAME": "lo", **(env or {})}
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, backend, store, pipes[r][1],
                               args_path),
                         daemon=True) for r in range(world)]
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)                     # inherited at start
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for _, send in pipes:                  # a rank's death reads as EOF
            send.close()
    results = {}
    waiting = {recv: r for r, (recv, _) in enumerate(pipes)}
    deadline = time.monotonic() + timeout
    done = False
    try:
        while waiting:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{world - len(results)} of {world} ranks did not finish "
                    f"within {timeout:.0f}s (ranks done: {sorted(results)})")
            for recv in connection.wait(list(waiting), timeout=left):
                rank = waiting.pop(recv)
                try:
                    ok, payload = recv.recv()
                except EOFError:
                    procs[rank].join(timeout=5.0)
                    raise RuntimeError(
                        f"rank {rank} exited with code "
                        f"{procs[rank].exitcode} and no report") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{payload}")
                results[rank] = payload
        done = True
    finally:
        for p in procs:
            if done:
                p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for recv, _ in pipes:
            recv.close()
        for path in (store, args_path):
            if os.path.exists(path):
                os.remove(path)
        # the tracker ends when every holder of its pipe has: a rank that
        # outlived its kill would make the wait for it hang
        if own_tracker and all(p.exitcode is not None for p in procs):
            tracker._stop()
    return [results[r] for r in range(world)]
