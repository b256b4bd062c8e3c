"""Build and load the CUDA kernels of ``joxsz_torch/csrc``.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/joxsz_torch_kernels/``
at the repository root (git ignores it), keyed by a hash of every source
and the flags, and loaded with ctypes.  All sources are compiled together,
one ``nvcc`` each in parallel, on the first call that needs a kernel.
A failed build raises; nothing falls back to plain torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[2] / "build"
              / "joxsz_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_L = ctypes.c_longlong
# C entry points: argument types (every launcher returns cudaGetLastError)
SIGNATURES = {
    "joint_ll": {
        "launch_joint_ll": [_P, _I, _P, _P, _P, _P, _P],
    },
    "stretch_step": {
        "launch_stretch_steps": [_P, _P, _P, _P, _P, _P, _I, _I, _U, _I, _I,
                                 _I, _P, _P, _F, _F, _I, _L, _P, _P, _P, _P,
                                 _P],
        "stretch_steps_config": [_I, _I, _P, _P, _P],
        "launch_coupled_half": [_P, _P, _P, _P, _I, _I, _I, _I, _U, _I, _F,
                                _F, _P, _P, _P, _P],
    },
    "sz_core": {
        "launch_sz_core": [_P, _P, _P, _I, _P, _P, _P, _P, _P],
    },
}

_LIBS: dict = {}
BUILD_INFO: dict = {}      # seconds, ptxas report per source, build dir


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> pathlib.Path:
    """Compile every ``csrc/*.cu`` (in parallel) unless this source hash is
    already built; returns the build directory."""
    out = BUILD_ROOT / _source_hash()
    names = sorted(SIGNATURES)
    if all((out / f"lib{n}.so").exists() for n in names):
        BUILD_INFO.setdefault("dir", str(out))
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = {}
    for n in names:
        tmp = out / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    logs, failed = {}, []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        logs[n] = log
        if proc.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, out / f"lib{n}.so")
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    BUILD_INFO.update(seconds=time.time() - t0, ptxas=logs, dir=str(out))
    return out


def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all sources on
    first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check_launch(err: int, what: str):
    """Raise on a non-zero CUDA error code from a launcher: a launch the
    card refused (too much shared memory, a cooperative grid that cannot
    be resident, no cooperative launch) or shapes the kernel does not
    take."""
    if err != 0:
        text = next(iter(_LIBS.values())).kernel_error_string(err).decode()
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError "
                           f"{err} ({text})")
