"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source is compiled by `nvcc` on first use into its own
shared library with a plain C interface, and loaded through `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -split-compile=0 -o <lib>.so csrc/<name>.cu

The libraries land in `build/repro_torch_kernels/` under the repository
root (listed in `.gitignore`; `REPRO_TORCH_BUILD_DIR` overrides it), named
by a digest of their sources and flags, so an edited source rebuilds and an
unchanged one loads at once.  `build_all()` starts one `nvcc` per source,
all at the same time, and waits for them together; `-split-compile=0`
lets each run its optimisation passes on every core (the sources with
24-30 template instances otherwise set the build's wall time); the compiler's
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
from typing import Callable, Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {
    "paged_decode": "paged_decode.cu",
    "paged_prefill": "paged_prefill.cu",
    "matmul": "matmul.cu",
    "conv2d": "conv2d.cu",
    "fused_elementwise": "fused_elementwise.cu",
    "flash_attention": "flash_attention.cu",
    "dense_decode": "dense_decode.cu",
    "sampling": "sampling.cu",
}
HEADERS = ("paged_attention.cuh", "mma_attention.cuh", "activation.cuh",
           "ptx.cuh", "split_decode.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=0")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_L = ctypes.c_longlong
# C signatures: every pointer and the stream as c_void_p (a bare Python int
# would be passed as a 32-bit int and cut the pointer)
SIGNATURES = {
    "paged_decode": ("paged_decode_attention",
                     [_P] * 6 + [_I] * 8 + [_F, _I, _P, _P, _P]),
    "paged_prefill": ("paged_prefill_attention",
                      [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _F, _I, _P]),
    "matmul": ("matmul_fused", [_P] * 4 + [_I] * 10 + [_P, _P, _P]),
    "conv2d": ("conv2d_direct", [_P] * 4 + [_I] * 18 + [_P] * 3),
    "fused_elementwise": ("fused_elementwise",
                          [_P] * 6 + [_L, _I, _U] + [_I] * 6 + [_P]),
    "flash_attention": ("flash_attention", [_P] * 4 + [_I] * 9 + [_F, _I, _P]),
    "dense_decode": ("dense_decode_attention",
                     [_P] * 5 + [_I] * 7 + [_F, _I, _P, _P, _P]),
    "sampling": ("sample_draw", [_P] * 8 + [_I] * 4 + [_P]),
}

_entry: Dict[str, object] = {}
_counters: Dict[tuple, object] = {}
# Every counter buffer that a larger one replaced.  A CUDA graph captured
# before the growth still holds the old buffer's address and replays into
# it, so no buffer is ever freed: each one stays alive, and zeroed by the
# kernels that use it, for the life of the process.
_superseded: List[object] = []
# The kernel wrappers whose plain int `launches` counts their launches.
_counted: List[Callable] = []


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
    needed; its argtypes/restype are set.  Kept after the first call, so a
    launch pays a dictionary lookup."""
    fn = _entry.get(name)
    if fn is None:
        build_all([name])
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(lib_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entry[name] = fn
    return fn


def _zeroed_counters(n: int, device):
    import torch

    return torch.zeros(n, dtype=torch.int32, device=device)


def counters(name: str, device, n: int):
    """At least `n` zeroed int32 arrival counters of kernel library `name`
    on a CUDA `device`, kept across launches: its split kernels reset every
    counter they use, so the buffer is zeroed once, when it is allocated
    (or grown), and never again.  Launches that share the buffer must run
    one after another (one stream), as the serving path's do.

    The buffer must exist before a CUDA graph that launches these kernels
    is captured: zeroing it inside a capture would only record the memset
    (and take the graph's memory), leaving eager launches after it with
    counters that were never zeroed.  So growing it while the current
    stream captures raises; an eager call at the same shapes first (a
    warm-up) allocates it.  A buffer that a later eager call outgrows is
    replaced for eager launches and kept alive (`_superseded`) for the
    graphs that captured it."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    buf = _counters.get((name, index))
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: {n} split counters must be allocated "
                               "before a CUDA graph capture; call once eagerly")
        if buf is not None:
            _superseded.append(buf)
        buf = _zeroed_counters(max(n, 1024), device)
        _counters[(name, index)] = buf
    return buf


def counted(fn: Callable) -> Callable:
    """Register a kernel wrapper that adds one to its plain int attribute
    `launches` where it launches its kernel.  A captured program reads the
    registry (`launch_counts`) to count the launches its replays make,
    which run no Python."""
    fn.launches = 0
    _counted.append(fn)
    return fn


def launch_counts() -> Dict[Callable, int]:
    """{wrapper: launches so far} of every counted wrapper."""
    return {fn: fn.launches for fn in _counted}


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
