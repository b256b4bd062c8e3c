"""Layout of the constants the CUDA kernels read (``csrc/joint_ll.cuh::
LLConsts``): one packed float32 buffer of named arrays at 16-byte-aligned
offsets, a vector of ints (sizes, the model family, the thawed column of
each role, the array offsets) and a vector of float scalars.
``joint_kernel`` fills all of it for the joint likelihood; ``sz_core``
fills the SZ part only and leaves the rest zero.

``detect_family`` is the port's copy of ``joxsz_tpu/ops/pallas_joint.py::
_detect_family``: which branch of the likelihood a thawed layout takes,
and ``knot_table`` the port's form of that kernel's knot weight rows.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# thawed-parameter roles in the order the kernel reads them (cix; enum
# Role in csrc/joint_ll.cuh): the flagship's 13, the Vikhlinin
# temperature's six, the double density's three, line_scale, and the
# first knot value (the knots follow it in order)
ROLES = ("log(n_0)", r"\beta", "log(r_c)", "log(r_s)", r"\epsilon",
         "log(T_X/T_{SZ})", "Z", "P_0", "a", "b", "r_p", "backscale",
         "calibration", "T_0", "T_{min}/T_0", "r_{cool}", "a_{cool}", "r_t",
         "c_t", "log(n_{02})", r"\beta_2", "log(r_{c2})", "line_scale",
         "logP_0")

# float-buffer arrays, in buffer order (enum Arr in csrc/joint_ll.cuh);
# KG / KM / KV: the knot tables of the pressure grid, the X-ray shell
# midpoints and the mass-veto radii (knot_table)
ARRAYS = ("r", "lnr", "LT", "GT", "flux", "wres", "wT0", "wint", "midr",
          "lnmid", "LR0", "LR1", "volsT", "sigf", "bgf", "cmf", "ctf", "lo",
          "hi", "wg", "mu", "convT", "convV", "convS", "mui", "KG", "KM",
          "KV")
# scalar ints / floats handed to the launch, in the C struct's order
INTS = ("n_press", "sep", "n_pix", "n_data", "n_sh", "n_ann", "n_band",
        "nT", "n_conv", "D", "mass_veto", "p_fam", "t_fam", "d_fam",
        "n_knots", "has_xray", "has_ls")
FLOATS = ("c_gnfw", "alpha", "gamma", "mass_C", "t0g", "inv_dtg", "pos_hi")


# family codes of the ints p_fam, t_fam, d_fam (enum Fam in joint_ll.cuh)
P_GNFW, P_KNOTS = 0, 1
T_UPP, T_VIKH, T_NONE = 0, 1, 2
D_SINGLE, D_DOUBLE = 0, 1
VIKH_T_PARAMS = ("T_0", "T_{min}/T_0", "r_{cool}", "a_{cool}", "r_t", "c_t")


def detect_family(thawed, has_xray: bool = True):
    """The likelihood branch of a thawed layout, as ``joxsz_tpu/ops/
    pallas_joint.py::_detect_family`` resolves it: pressure gnfw | knots,
    temperature upp | vikh | none (SZ-only with the ratio frozen: T_SZ =
    P/ne), density single | double, Z / backscale with X-ray data,
    calibration always, and line_scale optional with X-ray data.  Returns
    ``(p_fam, t_fam, d_fam, n_knots, cix)`` (codes above, ``cix`` name ->
    column), or None for any other layout."""
    names = set(thawed)
    if len(names) != len(thawed):
        return None
    base = {"log(n_0)", r"\beta", "log(r_c)", "log(r_s)", r"\epsilon",
            "calibration"}
    if has_xray:
        base |= {"Z", "backscale"}
    if not base <= names:
        return None
    if "log(T_X/T_{SZ})" in names:
        t_fam, t_set = T_UPP, {"log(T_X/T_{SZ})"}
    elif set(VIKH_T_PARAMS) <= names:
        t_fam, t_set = T_VIKH, set(VIKH_T_PARAMS)
    elif not has_xray:
        t_fam, t_set = T_NONE, set()
    else:
        return None
    if {"P_0", "a", "b", "r_p"} <= names:
        p_fam, n_knots, p_set = P_GNFW, 0, {"P_0", "a", "b", "r_p"}
    else:
        n_knots = sum(1 for n in names if n.startswith("logP_"))
        if n_knots < 2:
            return None
        p_set = {f"logP_{i}" for i in range(n_knots)}
        if not p_set <= names:
            return None
        # the kernel reads the knots as columns kc0 .. kc0 + n - 1
        k0 = thawed.index("logP_0")
        if (k0 + n_knots > len(thawed)
                or any(thawed[k0 + i] != f"logP_{i}"
                       for i in range(n_knots))):
            return None
        p_fam = P_KNOTS
    d_set = {"log(n_{02})", r"\beta_2", "log(r_{c2})"}
    if d_set <= names:
        d_fam = D_DOUBLE
    else:
        d_fam, d_set = D_SINGLE, set()
    ls_set = {"line_scale"} if (has_xray and "line_scale" in names) \
        else set()
    if names != base | t_set | p_set | d_set | ls_set:
        return None
    return (p_fam, t_fam, d_fam, n_knots,
            {n: i for i, n in enumerate(thawed)})


def family_key(ints: dict) -> tuple:
    """The ints that pick a layout's branches of the likelihood
    (``detect_family``'s codes, the knot count, X-ray and line_scale
    presence): equal for every cluster of a stack."""
    return tuple(int(ints[k]) for k in ("p_fam", "t_fam", "d_fam",
                                         "n_knots", "has_xray", "has_ls"))


def knot_table(knots_logr, logq, slopes: bool = False) -> np.ndarray:
    """The clamped lerp of knot values in log10 r at the radii ``logq``
    (log10), one row per radius: (segment i, weight of knot i, weight of
    knot i + 1) and with ``slopes`` (d/dlog10 r of the weights, 10^logq).
    The same function as the dense weight rows of ``pallas_joint.py``
    (AKP / AKM / AKV / SKV, :492-535), with strict inequalities at the
    first and last knot: a radius exactly on the last knot takes the
    last segment's slope, as autodiff of ``jnp.interp`` does.  Below the
    first knot the value is knot 0's, above the last knot knot n-1's,
    and the slope zero."""
    k = np.asarray(knots_logr, np.float64)
    n = k.size
    rows = []
    for lq in np.asarray(logq, np.float64):
        w0 = w1 = s0 = s1 = 0.0
        if lq < k[0]:
            i, w0 = 0, 1.0
        elif lq > k[-1]:
            i, w1 = n - 2, 1.0
        else:
            i = min(int(np.searchsorted(k, lq, "right")) - 1, n - 2)
            d = k[i + 1] - k[i]
            t = (lq - k[i]) / d
            w0, w1 = 1.0 - t, t
            s0, s1 = -1.0 / d, 1.0 / d
        rows.append((i, w0, w1) + ((s0, s1, 10.0 ** lq) if slopes else ()))
    return np.array(rows, dtype=np.float64).reshape(len(rows),
                                                    6 if slopes else 3)


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
    and kept alive beside their ctypes pointers.  Missing entries are 0
    (a role the layout does not thaw reads column 0, and its family never
    reads it)."""

    def __init__(self, ints: dict, roles: dict, offsets: dict,
                 floats: dict):
        roles = roles or {}
        iv = ([ints.get(k, 0) for k in INTS]
              + [roles.get(r, 0) for r in ROLES]
              + [offsets.get(k, 0) for k in ARRAYS])
        fv = [floats.get(k, 0.0) for k in FLOATS]
        self.iv = np.ascontiguousarray(iv, dtype=np.int32)
        self.fv = np.ascontiguousarray(fv, dtype=np.float32)
        self.iv_ptr = self.iv.ctypes.data_as(ctypes.c_void_p)
        self.fv_ptr = self.fv.ctypes.data_as(ctypes.c_void_p)
