"""Build the CUDA kernels with nvcc at first use and bind them with ctypes.

Each source under ``csrc/`` compiles on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
for ``sm_90a``, into the package's gitignored ``_build/`` directory.  The
library's file name carries a hash of its source, the ``csrc/`` headers
and its flags, so an edited kernel is rebuilt and a stale one is never
loaded.  :func:`build` starts
one nvcc per source, all at once; ``-Xptxas -v`` reports each kernel's
registers, shared memory and spills, printed once per build with each
source's build seconds.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.  There is no fallback: a kernel
that does not build or launch is an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("pack", "realign", "traceback", "viterbi", "viterbi_traceback",
           "forward")
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# the realign and forward kernels keep every multiply and add separately
# rounded, as their plain PyTorch versions do, so the two agree to the
# bit (the Viterbi kernel only adds and takes maxima)
_EXTRA = {"realign": ["-fmad=false"], "forward": ["-fmad=false"]}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Launches of one kernel: a plain integer, bumped by its wrapper
    where it launches the kernel (wrappers run on worker threads)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin/nvcc``, then PATH)."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the kernels build with the CUDA toolkit's nvcc "
        "(set CUDA_HOME)"
    )


def _flags(name: str) -> list[str]:
    return _FLAGS + _EXTRA.get(name, [])


def library_path(name: str) -> str:
    """The library's path: its name and a hash of its source, the
    headers under ``csrc/`` (the walkers share one) and its flags."""
    h = hashlib.sha1()
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            os.path.join(CSRC, f) for f in os.listdir(CSRC)
            if f.endswith(".cuh")):
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, h.hexdigest()[:12]))


def build(names=SOURCES) -> float:
    """Compile every library of ``names`` that is not built yet, one
    nvcc process per source, all started together.  Returns seconds."""
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if not os.path.exists(library_path(n))]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        compiler = nvcc()
        procs = []
        for name in todo:
            out = library_path(name)
            tmp = "%s.%d.tmp" % (out, os.getpid())
            cmd = [compiler] + _flags(name) + [
                os.path.join(CSRC, name + ".cu"), "-o", tmp,
            ]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        done = {}  # name -> (log, seconds), each read on its own thread

        def wait(name, proc):
            log, _ = proc.communicate()
            done[name] = (log, time.perf_counter() - t0)

        waiters = [threading.Thread(target=wait, args=(name, proc))
                   for name, _, _, proc in procs]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        failed = []
        for name, out, tmp, proc in procs:
            log, secs = done[name]
            if proc.returncode != 0:
                failed.append("%s:\n%s" % (name, log))
                continue
            os.replace(tmp, out)
            print("[nvcc %s] built %s in %.1f s" % (name, os.path.basename(out),
                                                  secs))
            for line in log.splitlines():
                if "ptxas" in line or "bytes stack frame" in line:
                    print("[nvcc %s] %s" % (name, line.strip()))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed.

    ``signatures`` maps each C function to its ctypes argument types;
    every function returns an int (a ``cudaError_t``).
    """
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(library_path(name))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.np_cuda_error_string.argtypes = [ctypes.c_int]
            lib.np_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(
            "%s launch failed: CUDA error %d (%s)"
            % (what, rc, lib.np_cuda_error_string(rc).decode())
        )


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer, for a ``c_void_p`` argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The calling thread's current stream on ``t``'s device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
