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
_PI = ctypes.POINTER(ctypes.c_int)
# C entry points: argument types (every launcher returns cudaGetLastError
# and writes the instance it launched into its last argument)
SIGNATURES = {
    "joint_ll": {
        "launch_joint_ll": [_P, _I, _P, _P, _P, _P, _P, _PI],
    },
    "stretch_step": {
        "launch_stretch_steps": [_P, _P, _P, _P, _P, _P, _I, _I, _U, _I, _I,
                                 _I, _P, _P, _F, _F, _I, _I, _L, _P, _P, _P,
                                 _P, _P, _PI],
        "stretch_steps_config": [_I, _I, _P, _P, _P],
        "launch_coupled_half": [_P, _P, _P, _P, _I, _I, _I, _I, _U, _I, _I,
                                _F, _F, _P, _P, _P, _P, _PI],
    },
    "sz_core": {
        "launch_sz_core": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _PI],
    },
}

# The compiled instances of each launcher, indexed by the number it
# reports (csrc/joint_ll.cuh::picked_instance: 2 x family + large; the SZ
# core: large), and the launches of each in this process (never reset:
# chip_smoke.py requires every instance launched over a whole run).
INSTANCES = {
    kind: tuple(f"{kind}{fam}{large}_kernel" for fam in ("", "_fam")
                for large in ("", "_large"))
    for kind in ("joint_ll", "stretch_steps", "coupled_half")}
INSTANCES["sz_core"] = ("sz_core_kernel", "sz_core_large_kernel")
instance_launches = {name: 0 for names in INSTANCES.values()
                     for name in names}

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
        lib.read_f64_pairs.argtypes = [_P, _I]
        lib.read_f64_pairs.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def f64_pairs(name: str, reset: bool = False) -> int:
    """The mass-veto pairs the float64 tier decided (``csrc/mass_veto.cuh::
    jt_f64_pairs``) over every launch of ``csrc/<name>.cu``'s kernels in
    this process since the last reset: 0 when the library is not loaded.
    Synchronises with the card (a copy from the device)."""
    lib = _LIBS.get(name)
    if lib is None:
        return 0
    out = ctypes.c_ulonglong(0)
    check_launch(lib.read_f64_pairs(ctypes.byref(out), int(reset)),
                 f"read_f64_pairs of {name}")
    return int(out.value)


def launch_checked(kind: str, fn, *args, what: str | None = None):
    """Call the C launcher ``fn`` of the ``INSTANCES[kind]`` kernels with
    ``args`` and a place for the instance it reports, raise on a non-zero
    CUDA error code (``check_launch``; ``what`` names the launch, default
    ``kind``), and count the launch of that instance."""
    picked = ctypes.c_int(-1)
    check_launch(fn(*args, ctypes.byref(picked)), what or kind)
    instance_launches[INSTANCES[kind][picked.value]] += 1


def check_launch(err: int, what: str):
    """Raise on a non-zero CUDA error code from a launcher: a launch the
    card refused (too much shared memory, a cooperative grid that cannot
    be resident, no cooperative launch) or shapes the kernel does not
    take."""
    if err != 0:
        text = next(iter(_LIBS.values())).kernel_error_string(err).decode()
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError "
                           f"{err} ({text})")
