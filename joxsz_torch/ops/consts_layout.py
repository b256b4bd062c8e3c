"""Layout of the constants the CUDA kernels read (``csrc/joint_ll.cuh::
LLConsts``): one packed float32 buffer of named arrays at 16-byte-aligned
offsets, a vector of ints (sizes, the thawed column of each role, the
array offsets) and a vector of float scalars.  ``joint_kernel`` fills all
of it for the joint likelihood; ``sz_core`` fills the SZ part only and
leaves the rest zero.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# thawed-parameter roles in the order the kernel reads them (cix)
ROLES = ("log(n_0)", r"\beta", "log(r_c)", "log(r_s)", r"\epsilon",
         "log(T_X/T_{SZ})", "Z", "P_0", "a", "b", "r_p", "backscale",
         "calibration")

# float-buffer arrays, in buffer order (enum Arr in csrc/joint_ll.cuh)
ARRAYS = ("r", "lnr", "LT", "GT", "flux", "wres", "wT0", "wint", "midr",
          "lnmid", "LR0", "LR1", "volsT", "sigf", "bgf", "cmf", "ctf", "lo",
          "hi", "wg", "mu", "convT", "convV", "convS", "mui")
# scalar ints / floats handed to the launch, in the C struct's order
INTS = ("n_press", "sep", "n_pix", "n_data", "n_sh", "n_ann", "n_band",
        "nT", "n_conv", "D", "mass_veto")
FLOATS = ("c_gnfw", "alpha", "gamma", "mass_C", "t0g", "inv_dtg", "pos_hi")


def check_conv_table(conv_T):
    """Raise ``ValueError`` unless the y->mJy table's temperatures never
    decrease: the kernels find the lerp's segment (the number of interior
    knots <= t) by bisection, which needs a sorted table."""
    t = np.asarray(conv_T, np.float64)
    if t.size < 2 or not np.all(np.diff(t) >= 0):
        raise ValueError("the y->mJy conversion table needs at least two "
                         "temperatures in non-decreasing order")


def pack_arrays(clusters: list[dict], device):
    """Pack one dict of arrays per cluster (same keys and shapes, any
    subset of ``ARRAYS``) into a (C, n) float32 buffer with identical
    offsets for every cluster.  Returns ``(buf, offsets, views)`` with
    ``views[c][name]`` the array of cluster c as a view into ``buf``."""
    names = [k for k in ARRAYS if k in clusters[0]]
    offsets, shapes, off = {}, {}, 0
    for k in names:
        shapes[k] = np.shape(clusters[0][k])
        offsets[k] = off
        size = int(np.prod(shapes[k]))
        off += size + (-size) % 4
    host = np.zeros((len(clusters), off), dtype=np.float32)
    for c, arrs in enumerate(clusters):
        for k in names:
            a = np.asarray(arrs[k], dtype=np.float32).ravel()
            host[c, offsets[k]:offsets[k] + a.size] = a
    buf = torch.from_numpy(host).to(device)
    views = [{k: buf[c, offsets[k]:offsets[k] + int(np.prod(shapes[k]))]
              .view(shapes[k]) for k in names} for c in range(len(clusters))]
    return buf, offsets, views


class LaunchParams:
    """The int and float vectors a launcher takes by pointer, built once
    and kept alive beside their ctypes pointers.  Missing entries are 0."""

    def __init__(self, ints: dict, cix: list, offsets: dict, floats: dict):
        iv = ([ints.get(k, 0) for k in INTS]
              + (list(cix) if cix else [0] * len(ROLES))
              + [offsets.get(k, 0) for k in ARRAYS])
        fv = [floats.get(k, 0.0) for k in FLOATS]
        self.iv = np.ascontiguousarray(iv, dtype=np.int32)
        self.fv = np.ascontiguousarray(fv, dtype=np.float32)
        self.iv_ptr = self.iv.ctypes.data_as(ctypes.c_void_p)
        self.fv_ptr = self.fv.ctypes.data_as(ctypes.c_void_p)
