"""The host library: the port's C++ (``deepspeed_tpu_torch/csrc``) built
with g++ at first use and bound with ctypes.

Counterpart of ``deepspeed_tpu/ops/native/__init__.py``. The sources are
the port's copies of the JAX package's ``cpu_adam.cpp`` (the host Adam,
Adagrad and Lion steps and the fp32 → bf16 cast), ``aio.cpp`` (the async
file I/O engine), ``atoms.cpp`` (the serving scheduler's plan packer,
``dstpu_build_atoms``) and ``threadpool.h``, compiled with the JAX loader's
flags, one object per source::

    g++ -O3 -march=native -std=c++17 -fPIC -fopenmp -Wall -c <source>

and linked ``-shared`` against the OpenMP runtime this process has loaded
(torch's), so one runtime serves both, into
``deepspeed_tpu_torch/ops/build/libdstpu_host_<hash>.so``. Linking
separately needs no ``libgomp.spec`` from the compiler (a g++ built
without libgomp refuses ``-fopenmp`` at the link). The hash covers the
sources, the flags, the runtime and the host CPU (``-march=native`` code
does not run on another CPU), so a changed source or another machine
builds again.

There is no quiet fallback: a failed build raises :class:`RuntimeError`
with the compiler's output. The plain torch versions in
``ops/cpu_optimizer.py`` and ``ops/aio.py`` run only where their caller
asks for them (``native=False``); the scheduler's Python packer only in
tests.

OpenMP: the library's loops take their team size from a ``num_threads``
clause, set once at load (``dstpu_set_num_threads``) to
``OMP_NUM_THREADS`` when it is set, else to the process's CPU affinity
count, and logged; torch's own team size is left as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time

from ..utils.logging import logger

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
SOURCES = ("aio.cpp", "atoms.cpp", "cpu_adam.cpp")
HEADERS = ("threadpool.h",)
FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-fopenmp", "-Wall")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: what the last build (or cache hit) did: path, seconds, built or cached
build_info: dict = {}


def num_threads() -> int:
    """The team size the host steps use: ``OMP_NUM_THREADS`` when set,
    else the process's CPU affinity count."""
    env = os.environ.get("OMP_NUM_THREADS", "").strip()
    if env:
        return max(1, int(env.split(",")[0]))
    return len(os.sched_getaffinity(0))


def _cpu_identity() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.processor() or platform.machine()


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the host library needs g++ on PATH (or CXX)")
    return cxx


def openmp_runtime(cxx: str) -> str:
    """The OpenMP runtime to link: the one this process has loaded (torch
    loads its own at import), else the compiler's ``libgomp.so.1``."""
    import torch  # noqa: F401  (loads torch's OpenMP runtime)

    with open("/proc/self/maps") as f:
        for line in f:
            path = line.split()[-1]
            if os.path.basename(path).startswith("libgomp") and \
                    ".so" in path and os.path.exists(path):
                return path
    res = subprocess.run([cxx, "-print-file-name=libgomp.so.1"],
                         capture_output=True, text=True)
    path = res.stdout.strip()
    if os.path.isabs(path) and os.path.exists(path):
        return path
    raise RuntimeError("no OpenMP runtime to link the host library "
                       "against: none is loaded and g++ has no libgomp")


def library_path(runtime: str = "") -> str:
    h = hashlib.sha256()
    for fname in SOURCES + HEADERS:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update(runtime.encode())
    h.update(_cpu_identity().encode())
    return os.path.join(BUILD_DIR, f"libdstpu_host_{h.hexdigest()[:16]}.so")


def _run(cmd: list[str]) -> None:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"host library build failed ({' '.join(cmd)}):\n"
                           f"{res.stdout}{res.stderr}")


def build_library() -> str:
    """Compile the library unless this exact build exists; returns its
    path. Raises RuntimeError with the compiler's output on failure."""
    t0 = time.perf_counter()
    cxx = _compiler()
    runtime = openmp_runtime(cxx)
    so_path = library_path(runtime)
    if os.path.exists(so_path):
        build_info.update(path=so_path, seconds=0.0, built=False,
                          openmp=runtime)
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}.{threading.get_ident()}"
    objs = [f"{tmp}.{os.path.splitext(src)[0]}.o" for src in SOURCES]
    try:
        for src, obj in zip(SOURCES, objs):
            _run([cxx, *FLAGS, "-c", os.path.join(CSRC, src), "-o", obj])
        _run([cxx, "-shared", *objs, runtime,
              f"-Wl,-rpath,{os.path.dirname(runtime)}", "-o", tmp,
              "-lpthread"])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, so_path)        # atomic against concurrent builders
    build_info.update(path=so_path, seconds=time.perf_counter() - t0,
                      built=True, openmp=runtime)
    return so_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, i32, f32 = ctypes.c_int64, ctypes.c_int, ctypes.c_float
    p, s = ctypes.c_void_p, ctypes.c_char_p
    lib.dstpu_aio_create.argtypes = [i32, i64]
    lib.dstpu_aio_create.restype = p
    lib.dstpu_aio_destroy.argtypes = [p]
    lib.dstpu_aio_destroy.restype = None
    for fn in (lib.dstpu_aio_read, lib.dstpu_aio_write):
        fn.argtypes = [p, s, p, i64, i64]
        fn.restype = i64
    lib.dstpu_aio_wait.argtypes = [p, i64]
    lib.dstpu_aio_wait.restype = i64
    lib.dstpu_aio_pending.argtypes = [p]
    lib.dstpu_aio_pending.restype = i32
    lib.dstpu_adam_step.argtypes = [p, p, p, p, i64, f32, f32, f32, f32, f32,
                                    i64, i32, i32]
    lib.dstpu_adam_step_bf16g.argtypes = [p, p, p, p, p, i64, f32, f32, f32,
                                          f32, f32, i64, i32, i32]
    lib.dstpu_adagrad_step.argtypes = [p, p, p, i64, f32, f32, f32]
    lib.dstpu_lion_step.argtypes = [p, p, p, i64, f32, f32, f32, f32]
    lib.dstpu_f32_to_bf16.argtypes = [p, p, i64]
    lib.dstpu_bf16_to_f32.argtypes = [p, p, i64]
    for fn in (lib.dstpu_adam_step, lib.dstpu_adam_step_bf16g,
               lib.dstpu_adagrad_step, lib.dstpu_lion_step,
               lib.dstpu_f32_to_bf16, lib.dstpu_bf16_to_f32):
        fn.restype = None
    lib.dstpu_num_threads.argtypes = []
    lib.dstpu_num_threads.restype = i32
    lib.dstpu_set_num_threads.argtypes = [i32]
    lib.dstpu_set_num_threads.restype = None
    lib.dstpu_build_atoms.argtypes = [i32, p, p, p, i32, i32, i32, i32,
                                      p, p, p, p, p, p, p, p]
    lib.dstpu_build_atoms.restype = i32
    return lib


def load_library() -> ctypes.CDLL:
    """Build (once) and load the library with its team size set. Raises
    RuntimeError when the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            path = build_library()
            lib = _bind(ctypes.CDLL(path))
            lib.dstpu_set_num_threads(num_threads())
            how = (f"built in {build_info['seconds']:.1f} s"
                   if build_info.get("built") else "cached")
            logger.info(f"host library {path} ({how}; "
                        f"{lib.dstpu_num_threads()} OpenMP threads, runtime "
                        f"{build_info['openmp']})")
            _lib = lib
    return _lib


def library_threads() -> int:
    """The library's team size."""
    return load_library().dstpu_num_threads()
