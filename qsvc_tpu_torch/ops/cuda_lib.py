"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file exposes a plain C interface and is compiled by
ONE ``nvcc`` call into ``qsvc_tpu_torch/_build/libqsvc_cuda.so``, which is
loaded with ``ctypes`` on first use (no PyTorch headers: the build takes
seconds).  A failed build raises with the compiler's output; there is no
fallback.  Nothing here runs at import, so CPU-only hosts import the
kernel modules freely.

``launches`` counts kernel launches per kernel name; the wrappers in
``cuda_me.py`` / ``cuda_mc.py`` / ``cuda_bp.py`` / ``cuda_interp.py`` add
one where they launch, so a run can show that its main path went through
the kernels.  While a CUDA graph is captured (``utils/graphs.py``)
nothing runs: :func:`counting_into` sends that thread's counts to the
graph's record, which each replay adds.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

#: launches per kernel name since the last :func:`reset_launches`
launches: collections.Counter = collections.Counter()

_lib = None
_lock = threading.Lock()
#: per thread: the Counter of the graph being captured, if any
_capturing = threading.local()
#: compiler output of the build in this process (ptxas register/smem use)
build_log = ""


def reset_launches() -> None:
    launches.clear()


@contextlib.contextmanager
def counting_into(counter: collections.Counter):
    """Count this thread's launches into ``counter`` instead of
    :data:`launches` (a graph capture records kernels and runs none)."""
    prev = getattr(_capturing, "counter", None)
    _capturing.counter = counter
    try:
        yield counter
    finally:
        _capturing.counter = prev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


def _build() -> str:
    global build_log
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    deps = srcs + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    so = os.path.join(BUILD_DIR, "libqsvc_cuda.so")
    if (os.path.exists(so) and os.path.getmtime(so)
            >= max(os.path.getmtime(s) for s in deps)):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", tmp, *srcs]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    build_log = proc.stdout + proc.stderr
    os.replace(tmp, so)            # atomic: concurrent builders never see
    return so                      # a half-written library


def load():
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.qsvc_me_refine.argtypes = ([vp] * 4 + [ci] * 5 + [vp]
                                           + [ci] * 11 + [vp])
            lib.qsvc_mc_predict.argtypes = [vp, vp, vp, vp] + [ci] * 8 + [vp]
            lib.qsvc_mc_update2.argtypes = [vp, vp, vp] + [ci] * 9 + [vp]
            lib.qsvc_mc_update1.argtypes = [vp] * 4 + [ci] * 9 + [vp]
            lib.qsvc_bp_slope.argtypes = [vp] * 5 + [ci] * 2 + [vp]
            lib.qsvc_stamp.argtypes = [vp, ci, vp]
            cl = ctypes.c_longlong
            lib.qsvc_interp_up.argtypes = ([vp, cl, ci, vp] * 2
                                           + [ci] * 3 + [vp])
            lib.qsvc_interp_down.argtypes = [vp, cl, ci, vp] + [ci] * 3 + [vp]
            for fn in (lib.qsvc_me_refine, lib.qsvc_mc_predict,
                       lib.qsvc_mc_update2, lib.qsvc_mc_update1,
                       lib.qsvc_bp_slope, lib.qsvc_stamp,
                       lib.qsvc_interp_up, lib.qsvc_interp_down):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def build_seconds() -> float:
    """Build (if needed) and load the library; returns seconds taken."""
    t0 = time.time()
    load()
    return time.time() - t0


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape, contiguous: bool = True) -> None:
    """Raise unless ``t`` is a CUDA tensor of dtype/shape, contiguous
    unless ``contiguous`` is False (the device is checked last, so a CPU
    tensor shows each other fault)."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def stamp(buf: torch.Tensor, index: int) -> None:
    """Write the card's clock (``%globaltimer``, ns) into ``buf[index]``
    (int64 on the card) once the work queued before on the current stream
    has run (``csrc/stamp.cu``).  The tracing's, not the codec's: not
    counted in :data:`launches`."""
    err = load().qsvc_stamp(ptr(buf), index, stream_ptr(buf))
    if err != 0:
        raise RuntimeError(f"CUDA kernel stamp failed to launch: "
                           f"cudaError {err}")


def launched(name: str, err: int) -> None:
    """Raise on a launch error (the C side returns cudaGetLastError())
    and count the launch (into the capture's record while capturing)."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    counter = getattr(_capturing, "counter", None)
    (launches if counter is None else counter)[name] += 1
