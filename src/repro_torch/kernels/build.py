"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source is compiled by `nvcc` on first use into its own
shared library with a plain C interface, and loaded through `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so csrc/<name>.cu

The libraries land in `build/repro_torch_kernels/` under the repository
root (listed in `.gitignore`; `REPRO_TORCH_BUILD_DIR` overrides it), named
by a digest of their sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  `build_all()` starts one `nvcc` per source,
all at the same time, and waits for them together; the compiler's
`-Xptxas -v` report (registers, shared memory, spills) is kept beside each
library as `<lib>.log`.

Nothing here runs at import time: this module is imported on machines
without a GPU or `nvcc`, where only the kernels' plain versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "paged_decode": "paged_decode.cu",
    "paged_prefill": "paged_prefill.cu",
    "matmul": "matmul.cu",
}
HEADERS = ("paged_attention.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream as c_void_p (a bare Python int
# would be passed as a 32-bit int and cut the pointer)
SIGNATURES = {
    "paged_decode": ("paged_decode_attention",
                     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]),
    "paged_prefill": ("paged_prefill_attention",
                      [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _F, _I, _P]),
    "matmul": ("matmul_fused", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return path


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (SOURCES[name],) + HEADERS:
        h.update((CSRC / src).read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / SOURCES[name])]


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library in parallel (one nvcc per source);
    returns {name: seconds spent building it} (0.0 when already built).
    Raises RuntimeError with the compiler's output on any failure."""
    names = list(names or SOURCES)
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {n: 0.0 for n in names}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs[name] = (subprocess.Popen(_command(name, tmp), stdout=log,
                                        stderr=subprocess.STDOUT),
                       tmp, out, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            failed.append((name, out.with_suffix(".log").read_text()[-4000:]))
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {n}\n{text}" for n, text in failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report for `name`'s library ('' when none was kept)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str):
    """The C entry point of kernel library `name`, building it first if
    needed; its argtypes/restype are set."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(str(lib_path(name)))
    symbol, argtypes = SIGNATURES[name]
    fn = getattr(_loaded[name], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
