"""Build the port's hand-written CUDA kernels at first use and bind them
with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so ``nvcc`` builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so <name>.cu

The library lands in ``src/repro_torch/_build/`` (listed in
``.gitignore``), named by a hash of its source, every shared header
(``csrc/*.cuh``, such as ``hopper.cuh``) and the flags, so an edited source
or header rebuilds and an unchanged one is loaded from disk. The ptxas
report (registers, shared memory, spills per kernel) is kept in
:data:`PTXAS_LOG` and beside the library as ``<name>-<hash>.ptxas.txt``.

Every C entry returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code. A missing ``nvcc`` or a failed build raises: there is no
fallback to the plain PyTorch versions on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: per-kernel argument types of each exported C function
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "paged_attention": {
        # q, k_pages, v_pages, table, pos, out, B, Hq, Hkv, D, page_size,
        # P, stream
        name: [_P] * 6 + [_I] * 6 + [_P]
        for name in ("paged_attention_f32", "paged_attention_bf16")},
    "fused_mlp": {
        # x, w_gate, w_up, w_down, h (scratch), out, T, d, f, stream
        "fused_mlp_f32": [_P] * 6 + [_I] * 3 + [_P],
        # x, w_gate, w_up, w_down, h, partials (split-K scratch), out, T,
        # d, f, down_splits, gate_tail, gate_splits, stream
        "fused_mlp_bf16": [_P] * 7 + [_I] * 6 + [_P]},
    "flash_attention": {
        # q, k, v, out, B, S, T, Hq, Hkv, D, causal, window, stream
        name: [_P] * 4 + [_I] * 8 + [_P]
        for name in ("flash_attention_f32", "flash_attention_bf16")},
    "ssd_scan": {
        # x, dt, A, B, C, y, h_last, b, s, h, p, n, q, the batch and row
        # strides of x, dt, B and C, stream
        name: [_P] * 7 + [_I] * 6 + [_L] * 8 + [_P]
        for name in ("ssd_scan_f32", "ssd_scan_bf16")},
}

#: name -> the ptxas ``-v`` lines of its last build (or of the cached one)
PTXAS_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from src/repro_torch/csrc at first use")


def _target(name: str) -> Path:
    """The library path for ``name``: a hash of its source, every header in
    ``CSRC`` (any of them may be included) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built;
    returns (target, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp)


def _finish(name: str, target: Path, job) -> None:
    log_path = target.with_suffix(".ptxas.txt")
    if job is not None:
        proc, tmp = job
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{out}")
        log_path.write_text(out)
        os.replace(tmp, target)
    PTXAS_LOG[name] = log_path.read_text() if log_path.exists() else ""


def _bind(name: str, target: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, ctypes.CDLL]:
    """Build (one nvcc per source, all started together) and load every
    named kernel library; returns name -> loaded library."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        jobs = {n: _start(n) for n in todo}
        for n, (target, job) in jobs.items():
            _finish(n, target, job)
            _LIBS[n] = _bind(n, target)
        return {n: _LIBS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built at first use."""
    lib = _LIBS.get(name)
    return lib if lib is not None else build_all([name])[name]


def check(code: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (``cudaGetLastError``)."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
