"""Kernel 1: the whole joint log-posterior of a batch of walkers.

Replaces ``joxsz_tpu/ops/pallas_joint.py::make_joint_core`` and the body it
wraps, ``ll_body`` (specialised by ``_build_spec``).  Per walker: box and
Gaussian priors, the r_c <= r_s veto, P and the Vikhlinin n_e on the
pressure grid, the HSE-mass monotonicity veto, the SZ chain (``pp @ L^T``
-> T-dependent y->mJy lerp x calibration -> ``@ G^T`` -> -chi^2/2, plus
the integrated-Y term) and the X-ray chain (count-rate lookup per band
and shell, ``ne^2``, shell->annulus projection through ``vols_norm``,
Cash with the positivity veto).

Every model family of ``ll_body`` is a branch here, chosen from the
thawed layout by ``consts_layout.detect_family`` (the port's
``_detect_family``) and passed to the kernel as ints: pressure gNFW (with
dP/dr and the dense-grid mass veto) or knots (log10 P a clamped lerp of
the knot values in log10 r, from a per-radius table of (segment, two
weights): two FP32 products a radius where the TPU kernel multiplied
dense weight rows, and the mass veto on the segment midpoints);
temperature UPP (T_SZ = P/ne, T_X = T_SZ 10^ratio), Vikhlinin (one
parametric T for both) or none (SZ-only); density single or double
(+ a beta-model term); the ``line_scale`` nuisance (Z_eff = Z x
line_scale); and SZ-only sessions, which have no X-ray block.  A layout
outside every family raises ``NotImplementedError``.

Host-side constants follow ``_cluster_arrays``/``_build_spec`` without the
TPU's 128-lane padding: the hat-basis MXU product the TPU uses for the
count-rate lookup is computed here as its two non-zero taps
``max(0, 1-|pos-k|)`` at k = floor(pos) and floor(pos)+1 (the tap past
the last grid point is zero, not clamped).  Everything ``_cluster_arrays``
treats as per cluster (operators, flux, counts, tables, the integrated-Y
weights and centre) lives in the packed float buffer, so the constants of
C clusters stack into one (C, n) buffer with shared offsets and scalars:
``pack_consts_stack``, the port's ``make_multicluster_consts``; a
session's own ``pack_consts`` is a stack of one.

CUDA kernel: ``csrc/joint_ll.cu`` over the shared device function in
``csrc/joint_ll.cuh``: as many blocks of 512 threads as the card holds at
once, each staging the packed constants (L^T is 313 x 86 f32, ~108 KB, at
the CL J1226 shapes) in shared memory once and walking tiles of 16
walkers whose profiles live beside them (at shapes where these do not fit,
the constants are read in place and then the profiles kept in global
memory: ``csrc/joint_ll.cuh::plan_launch``); every phase is spread over the
block, the long sums split across warps in a fixed order, plain FP32
FMAs.  What bounds it on the card: operations (~84 k a walker against
~60 bytes of input).

``joint_ll_plain`` is the same arithmetic in plain torch float32 (the
mirror of ``ll_body``); the wrapper ``joint_ll`` runs it only for a CPU
tensor and launches the kernel for a CUDA tensor.  Where ``ll_body``'s
float32 form leaves float32's range at the corners of the prior box, both
take 1/n_e and P/n_e from ln n_e^2 where n_e^2 is not a normal float, and
the mass veto compares the mass scaled by n_0 / |P_0| and rid of its
constant factor: a product, or a signed logarithm for a row one of whose
radii has n_e^2 not normal; a pair of masses that comparison cannot
order for sure is decided as the float64 model decides it
(``ops/mass_veto.py``, ``csrc/mass_veto.cuh``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .consts_layout import (MAX_D, ROLES, LaunchParams, P_KNOTS, T_VIKH,
                            D_DOUBLE, check_conv_table, detect_family,
                            knot_table, pack_arrays, split_f64,
                            veto_grid_rows, veto_knot_rows)
from . import mass_veto
from .sz_core import conv_slopes, sz_chain_plain, sz_padded_data

LN10 = float(np.log(10.0))
# exp(x) is a normal float32 above this (ln FLT_MIN = -87.34)
LN_NORMAL = -87.0


class StackMismatch(ValueError):
    """A multi-cluster stack breaks the kernels' shared-instrument
    requirement (``pallas_joint.py::StackMismatch``): the survey fit
    catches exactly this and samples through the plain batched
    likelihood instead; any other error propagates."""


@dataclasses.dataclass
class JointConsts:
    """Float32 constants of the kernel for one cluster, on one device."""

    arrays: dict          # name -> f32 tensor (views into ``buf``)
    buf: torch.Tensor     # every array, packed (16-byte aligned offsets)
    offsets: dict         # name -> float offset into ``buf``
    ints: dict
    floats: dict
    roles: dict           # thawed column of each role of ROLES thawed
    params: LaunchParams = None   # what the C entry points read

    @property
    def device(self):
        return self.buf.device

    @property
    def cix(self) -> list:
        """The thawed columns of the roles the layout thaws, in ROLES
        order."""
        return [self.roles[r] for r in ROLES if r in self.roles]

    def __post_init__(self):
        if self.params is None:
            self.params = LaunchParams(self.ints, self.roles, self.offsets,
                                       self.floats)

    def to(self, device) -> "JointConsts":
        """These constants on ``device`` (a copy of the buffer; itself
        when they already lie there)."""
        if _same_device(self.device, device):
            return self
        return _view_consts(self.buf.to(device), self)


@dataclasses.dataclass
class JointConstsStack:
    """The constants of C clusters in one (C, n) float32 buffer with the
    same offsets, sizes and scalars for every cluster (the port's
    ``make_multicluster_consts``).  ``clusters[c]`` is cluster c's
    ``JointConsts``, a view of row c."""

    buf: torch.Tensor
    clusters: list

    @property
    def device(self):
        return self.buf.device

    @property
    def n_clusters(self) -> int:
        return self.buf.shape[0]

    @property
    def stride(self) -> int:
        return self.buf.shape[1]

    @property
    def ints(self) -> dict:
        return self.clusters[0].ints

    @property
    def params(self) -> LaunchParams:
        return self.clusters[0].params

    def block(self, c0: int, c1: int, device=None) -> "JointConstsStack":
        """The stack of clusters ``c0 .. c1`` on ``device`` (default: where
        the stack lies): what one shard of a cluster mesh holds."""
        buf = self.buf[c0:c1]
        if device is not None and not _same_device(self.device, device):
            buf = buf.to(device)
        return JointConstsStack(buf=buf, clusters=[
            _view_consts(buf[i], cc)
            for i, cc in enumerate(self.clusters[c0:c1])])


def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.type == "cpu" or b.index is None
                                 or a.index == b.index)


def _view_consts(row: torch.Tensor, like: JointConsts) -> JointConsts:
    """``like``'s layout over the packed row ``row`` (n,)."""
    arrays = {k: row[like.offsets[k]:like.offsets[k] + v.numel()]
              .view(v.shape) for k, v in like.arrays.items()}
    return JointConsts(arrays=arrays, buf=row, offsets=like.offsets,
                       ints=like.ints, floats=like.floats, roles=like.roles,
                       params=like.params)


def _np(t):
    return t.detach().cpu().numpy().astype(np.float64)


def _session_spec(sess) -> dict:
    """What every cluster of a stack shares with the session: the model
    family, the thawed layout, priors and frozen shape parameters, the
    grids and the sizes (the port's ``_build_spec`` statics)."""
    m = sess.model
    p = m.params
    sz, xr = m.sz_data, m.xray_data
    has_xray = xr is not None
    fam = detect_family(p.thawed, has_xray=has_xray)
    if fam is None or (fam[0] == P_KNOTS
                       and not hasattr(m.pressure, "knots_logr")):
        raise NotImplementedError(
            "the joint kernel covers the model families of joxsz_tpu's "
            "_detect_family (gnfw | knots pressure, upp | vikhlinin | none "
            "temperature, single | double density, optional line_scale, "
            f"SZ-only); this session thaws {p.thawed}")
    p_fam, t_fam, d_fam, n_knots, cix = fam
    if len(p.thawed) > MAX_D:
        raise ValueError(f"at most {MAX_D} thawed parameters")
    # Gaussian weight isg / sigma^2, formed in float32 as ll_body does
    isg32 = p.is_gauss.astype(np.float32)
    sg32 = np.where(p.is_gauss, p.sigma, 1.0).astype(np.float32)
    n_data, n_pix = sz.G.shape
    mass_veto = bool(m.exclude_unphysical_mass)
    ints = dict(n_press=sz.r_press_kpc.shape[0], sep=int(sz.sep),
                n_pix=n_pix, n_data=n_data, n_conv=sz.conv_T.shape[0],
                D=len(p.thawed), mass_veto=int(mass_veto), p_fam=p_fam,
                t_fam=t_fam, d_fam=d_fam, n_knots=n_knots,
                has_xray=int(has_xray), has_ls=int("line_scale" in cix),
                n_sh=0, n_ann=0, n_band=0, nT=0)
    floats = dict(c_gnfw=float(p["c"].val) if "c" in p else 0.0,
                  alpha=float(p[r"\alpha"].val),
                  gamma=float(p[r"\gamma"].val),
                  t0g=0.0, inv_dtg=0.0, pos_hi=0.0)
    # the float64 tier of the mass veto reads the frozen shape parameters
    # as float32 pairs
    for k in ("c_gnfw", "alpha", "gamma"):
        floats[k.split("_")[0] + "_lo"] = float(split_f64(floats[k])[1])
    Tlog = np.zeros(0)
    if has_xray:
        Tlog = _np(xr.table.Tlog)
        n_ann, n_sh = xr.vols_norm.shape
        ints.update(n_sh=n_sh, n_ann=n_ann, n_band=xr.counts_mask.shape[0],
                    nT=Tlog.size)
        floats.update(t0g=float(Tlog[0]),
                      inv_dtg=1.0 / float(Tlog[1] - Tlog[0]),
                      pos_hi=float(Tlog.size - 1 - 1e-6))
    check_conv_table(_np(sz.conv_T))
    if ints["n_pix"] != ints["sep"] + 1:
        raise ValueError("the SZ operator must have sep + 1 pixels")
    roles = {r: cix[r] for r in ROLES if r in cix}
    return dict(
        ints=ints,
        floats={k: float(np.float32(v)) for k, v in floats.items()},
        roles=roles, knots_logr=(np.asarray(m.pressure.knots_logr)
                                 if p_fam == P_KNOTS else None),
        r_pp=_np(sz.r_press_kpc), conv_T=_np(sz.conv_T),
        conv_V=_np(sz.conv_val), Tlog=Tlog,
        priors={"lo": np.where(np.isfinite(p.lo), p.lo, -1e30),
                "hi": np.where(np.isfinite(p.hi), p.hi, 1e30),
                "wg": isg32 / (sg32 * sg32), "mu": p.mu})


def _cluster_arrays(spec: dict, sz, xr) -> dict:
    """The float64 arrays of ONE cluster in ``consts_layout.ARRAYS``
    names, after checking what the stack must share with the session
    (the checks of ``pallas_joint.py::_cluster_arrays``)."""
    I = spec["ints"]
    r_pp = _np(sz.r_press_kpc)
    if r_pp.shape != spec["r_pp"].shape or not np.allclose(r_pp,
                                                           spec["r_pp"]):
        raise StackMismatch("pressure radial grid differs across the stack")
    if int(sz.sep) != I["sep"]:
        raise StackMismatch("map geometry (sep) differs across the stack")
    conv_T, conv_V = _np(sz.conv_T), _np(sz.conv_val)
    if conv_T.shape != spec["conv_T"].shape or not (
            np.allclose(conv_T, spec["conv_T"])
            and np.allclose(conv_V, spec["conv_V"])):
        raise StackMismatch("y->mJy conversion tables differ across the "
                            "stack")
    if (xr is None) != (not I["has_xray"]):
        raise StackMismatch("X-ray data presence differs across the stack")
    if sz.flux.shape[0] > I["n_data"]:
        raise StackMismatch("flux profile longer than the session's data "
                            "axis (heterogeneous stack)")
    flux, wres = sz_padded_data(_np(sz.flux), _np(sz.flux_err))
    # integrated-Y term -(wint.pp - mui)^2 / 2 with 1/sigma folded in;
    # zero weights switch it off (pallas_joint.py:333-343)
    if sz.calc_integ:
        wint = _np(sz.integ_w) / float(sz.integ_sig)
        mui = float(sz.integ_mu) / float(sz.integ_sig)
    else:
        wint, mui = np.zeros_like(r_pp), 0.0
    arrs = {
        "r": r_pp, "lnr": np.log(r_pp), "LT": _np(sz.L).T, "GT": _np(sz.G).T,
        "flux": flux, "wres": wres, "wT0": _np(sz.w_T0), "wint": wint,
        **spec["priors"],
        "convT": conv_T, "convV": conv_V,
        "convS": conv_slopes(conv_T, conv_V), "mui": np.array([mui]),
    }
    want = {"LT": (I["n_press"], I["n_pix"]), "GT": (I["n_pix"], I["n_data"]),
            "flux": (I["n_data"],), "wT0": (I["sep"],)}
    if xr is not None:
        Tlog = _np(xr.table.Tlog)
        if Tlog.shape != spec["Tlog"].shape or not np.allclose(
                Tlog, spec["Tlog"]):
            raise StackMismatch("count-rate log-T grids differ across the "
                                "stack")
        midr = _np(xr.midpt_kpc)
        exps = _np(xr.exposures)
        arrs.update({
            "midr": midr, "lnmid": np.log(midr),
            "LR0": _np(xr.table.lograte_Z0), "LR1": _np(xr.table.lograte_Z1),
            "volsT": _np(xr.vols_norm).T, "sigf": exps * _np(xr.areascales),
            "bgf": _np(xr.backrates) * exps * _np(xr.areas),
            "cmf": _np(xr.counts_mask), "ctf": _np(xr.counts_filled)})
        want.update({"midr": (I["n_sh"],), "LR0": (I["n_band"], I["nT"]),
                     "LR1": (I["n_band"], I["nT"]),
                     "volsT": (I["n_sh"], I["n_ann"]),
                     "cmf": (I["n_band"], I["n_ann"])})
    if I["p_fam"] == P_KNOTS:
        # the knot tables of this cluster's radii (pallas_joint.py builds
        # AKM from the session's midpoints; here each cluster its own)
        k = spec["knots_logr"]
        arrs["KG"] = knot_table(k, np.log10(r_pp))
        if xr is not None:
            arrs["KM"] = knot_table(k, np.log10(arrs["midr"]))
        if I["mass_veto"]:
            arrs["KV"] = knot_table(k, (k[:-1] + k[1:]) / 2.0, slopes=True)
            arrs["KX"] = veto_knot_rows(k)
    elif I["mass_veto"]:
        arrs.update(veto_grid_rows(r_pp))
    for k, shape in want.items():
        if arrs[k].shape != shape:
            raise StackMismatch(f"{k} has shape {arrs[k].shape}, the "
                                f"session's is {shape}")
    return arrs


def _pack(spec: dict, clusters: list[dict], dev) -> JointConstsStack:
    buf, offsets, views = pack_arrays(clusters, dev)
    params = LaunchParams(spec["ints"], spec["roles"], offsets,
                          spec["floats"])
    return JointConstsStack(buf=buf, clusters=[
        JointConsts(arrays=views[c], buf=buf[c], offsets=offsets,
                    ints=spec["ints"], floats=spec["floats"],
                    roles=spec["roles"], params=params)
        for c in range(len(clusters))])


def pack_consts(sess, device=None) -> JointConsts:
    """Build the kernel constants of a session (the port's
    ``_cluster_arrays`` + ``_build_spec``)."""
    dev = torch.device(device) if device is not None else sess.device
    spec = _session_spec(sess)
    m = sess.model
    return _pack(spec, [_cluster_arrays(spec, m.sz_data, m.xray_data)],
                 dev).clusters[0]


def pack_consts_stack(sess, sz_stack, xray_stack,
                      device=None) -> JointConstsStack:
    """Build the constants of a stack of C clusters (``models.
    multicluster.stack_sz_data`` / ``stack_xray_data``) that share the
    session's model, priors and instrument grids.  Operators, flux,
    counts, tables and the integrated-Y centre are per cluster.  Raises
    ``StackMismatch`` when a cluster's pressure grid, ``sep``, conversion
    table, X-ray presence or count-rate log-T grid differs from the
    session's, or its flux is longer than the session's data axis."""
    from ..models.multicluster import unstack

    dev = torch.device(device) if device is not None else sess.device
    spec = _session_spec(sess)
    C = sz_stack.L.shape[0]
    clusters = [_cluster_arrays(
        spec, unstack(sz_stack, c),
        None if xray_stack is None else unstack(xray_stack, c))
        for c in range(C)]
    return _pack(spec, clusters, dev)


def _nanmax(x, v):
    """max(x, v) that keeps NaN (``jnp.maximum`` semantics)."""
    return torch.where(torch.isnan(x), x, torch.clamp(x, min=v))


def _nanclip(x, lo, hi):
    return torch.where(torch.isnan(x), x, torch.clamp(x, lo, hi))


def _knot_lerp(th: torch.Tensor, kc0: int, table: torch.Tensor,
               cols=(1, 2)) -> torch.Tensor:
    """(B, n) sum of the knot values at each row's segment i, i + 1 times
    the table's weight columns ``cols`` (knot_table)."""
    i = table[:, 0].long() + kc0
    return th[:, i] * table[:, cols[0]] + th[:, i + 1] * table[:, cols[1]]


def _signed_log_mass(lm, sgn):
    """A mass sgn exp(lm) as sgn ln(1 + exp(lm)): strictly increasing in
    the mass, and finite where exp(lm) passes float32's range
    (csrc/joint_ll.cuh::signed_log_mass)."""
    return sgn * (torch.clamp(lm, min=0.0) + torch.log1p(torch.exp(
        -lm.abs())))


def _over_ne(p, dens):
    """p / n_e from ``dens``'s (1/n_e, n_e^2, ln n_e^2, normal): p x 1/n_e
    where n_e^2 is normal, else exp(ln p - ln n_e^2 / 2), which stays
    finite where 1/n_e alone would pass float32's range."""
    ne_inv, _, ln_ne2, normal = dens[:4]
    return torch.where(normal, p * ne_inv,
                       torch.exp(torch.log(p) - 0.5 * ln_ne2))


def joint_ll_plain(theta: torch.Tensor, c: JointConsts,
                   veto_details: dict | None = None) -> torch.Tensor:
    """(B, D) float32 -> (B,) float32 log-posterior: the kernel's
    arithmetic in plain torch (the mirror of ``ll_body``), every family
    branch included.  ``veto_details``, if given, receives the mass
    veto's tiers on every pair (``mass_veto.gnfw_veto`` / ``knot_veto``)
    and the masses (``m``, ``wide``)."""
    A, I, F = c.arrays, c.ints, c.floats
    th = theta.to(torch.float32)
    NEG = torch.tensor(-float("inf"), dtype=torch.float32, device=th.device)
    knots, vikh = I["p_fam"] == P_KNOTS, I["t_fam"] == T_VIKH

    def col(role):
        return th[:, c.roles[role]:c.roles[role] + 1]

    log_n0, beta = col("log(n_0)"), col(r"\beta")
    log_rc, log_rs, eps = col("log(r_c)"), col("log(r_s)"), col(r"\epsilon")
    cal = col("calibration")
    cg, alpha, gamma = F["c_gnfw"], F["alpha"], F["gamma"]

    # priors
    inside = ((th >= A["lo"]) & (th <= A["hi"])).all(dim=1, keepdim=True)
    dres = th - A["mu"]
    gauss = -0.5 * (A["wg"] * dres * dres).sum(dim=1, keepdim=True)
    total = torch.where(inside, gauss, NEG)
    total = torch.where(log_rc > log_rs, NEG, total)

    # pressure on the grid (+ the gNFW derivative fraction)
    r = A["r"]
    if knots:
        kc0 = c.roles["logP_0"]

        def press_knots(table):
            return torch.exp(LN10 * _knot_lerp(th, kc0, table))

        press = press_knots(A["KG"])
    else:
        P0, a_, b_, rp_ = col("P_0"), col("a"), col("b"), col("r_p")
        lnrp = torch.log(rp_)
        bca = (b_ - cg) / a_

        def press_of(lnr_row):
            """(P, ln(1 + x^a), ln(P / P_0)) at ln r."""
            lnx = lnr_row - lnrp
            za = a_ * lnx
            ln1xa = torch.clamp(za, min=0.0) + torch.log1p(
                torch.exp(-za.abs()))
            lnp = -cg * lnx - bca * ln1xa
            return P0 * torch.exp(lnp), ln1xa, lnp

        press, ln1xa, lnp = press_of(A["lnr"])
        p_rel = torch.exp(lnp)                              # P / P_0
        sfrac = 1.0 - torch.exp(-ln1xa)

    # Vikhlinin density (+ the double mode's beta-model term)
    rci = 10.0 ** (-log_rc)
    rsi = 10.0 ** (-log_rs)
    n0 = 10.0 ** log_n0
    n0sq = n0 * n0
    lnn0sq = torch.log(n0sq)
    e_c = 3.0 * beta - alpha / 2.0
    e_s = eps / gamma
    if I["d_fam"] == D_DOUBLE:
        n02 = 10.0 ** col("log(n_{02})")
        n02sq = n02 * n02
        lnn02sq = torch.log(n02sq)
        rc2i = 10.0 ** (-col("log(r_{c2})"))
        e2 = -3.0 * col(r"\beta_2")

    def dens(rr):
        """(1/n_e, n_e^2, ln n_e^2, normal, q, parts) at rr: n_e^2 as a
        product of exponentials, q = ln(n_e^2 / n_0^2) and ln n_e^2
        beside it; where every factor of the product is a normal float
        (normal) 1/n_e is rsqrt(n_e^2), else exp(-ln n_e^2 / 2).  parts:
        the log1p terms l1 = ln(1 + x_c^2), l2 = ln(1 + x_s^gamma) (and
        l3, the double mode's), q1 the first term's q, ln x_c (the mass
        veto's error bounds)."""
        xc = rr * rci
        xs = rr * rsi
        xs_g = xs * xs * xs if gamma == 3.0 else xs ** gamma
        l1, l2 = torch.log1p(xc * xc), torch.log1p(xs_g)
        q = -e_c * l1 - e_s * l2
        ne2 = n0sq * torch.exp(q)
        normal = (q > LN_NORMAL) & (lnn0sq + q > LN_NORMAL)
        parts = dict(l1=l1, l2=l2)
        if alpha != 0.0:
            ne2 = ne2 * xc ** (-alpha)
            parts["lnxc"] = torch.log(xc)
            q = q - alpha * parts["lnxc"]
        parts["q1"] = q
        if I["d_fam"] == D_DOUBLE:
            x2 = rr * rc2i
            parts["l3"] = torch.log1p(x2 * x2)
            q2 = e2 * parts["l3"]
            ne2 = ne2 + n02sq * torch.exp(q2)
            d2 = (lnn02sq - lnn0sq) + q2
            hi_, lo_ = torch.maximum(q, d2), torch.minimum(q, d2)
            q = hi_ + torch.log1p(torch.exp(lo_ - hi_))
            normal = normal & (q2 > LN_NORMAL) & (lnn02sq + q2 > LN_NORMAL)
        parts["q"] = q
        ln_ne2 = lnn0sq + q
        normal = normal & (ln_ne2 > LN_NORMAL)
        ne_inv = torch.where(normal, torch.rsqrt(ne2),
                             torch.exp(-0.5 * ln_ne2))
        return ne_inv, ne2, ln_ne2, normal, q, parts

    if vikh:
        T0v, tminr = col("T_0"), col("T_{min}/T_0")
        rcli, acool = 1.0 / col("r_{cool}"), col("a_{cool}")
        rti, cth = 1.0 / col("r_t"), -0.5 * col("c_t")

        def vikh_T(rr):
            xcl = torch.exp(acool * torch.log(rr * rcli))
            xt = rr * rti
            cool = (xcl + tminr) / (xcl + 1.0)
            return T0v * cool * torch.exp(cth * torch.log1p(xt * xt))

    dens_r = dens(r)

    # HSE-mass veto on the mass scaled by n_0 / |P_0| (by n_0 for knot
    # pressure), its constant factor dropped, which keeps its order; the
    # float32 comparison where it is sure, else the exact tiers of
    # ops.mass_veto (the float64 model's verdict)
    if I["mass_veto"]:
        sc = dict(ec=e_c, es=e_s, rci=rci, rsi=rsi, lnn0sq=lnn0sq)
        if I["d_fam"] == D_DOUBLE:
            sc.update(e2=e2, ln02=lnn02sq, rc2i=rc2i)
    if I["mass_veto"] and knots:
        # the segment-averaged mass at one log-midpoint per segment,
        # strictly increasing and ending positive
        KV = A["KV"]
        rm = KV[:, 5]
        lnpm = LN10 * _knot_lerp(th, kc0, KV)
        slope = _knot_lerp(th, kc0, KV, cols=(3, 4))
        dens_m = dens(rm)
        lpn = lnpm - 0.5 * dens_m[4]
        m = -slope * rm * torch.exp(lpn)
        # the signed log form for a row one of whose masses the product
        # takes past float32's range
        wide = ~(torch.isfinite(m) & (m != 0.0)).all(dim=1, keepdim=True)
        if wide.any():
            m = torch.where(wide, _signed_log_mass(
                torch.log(slope.abs()) + torch.log(rm) + lpn,
                -torch.sign(slope)), m)
        seg = KV[:, 0].long() + kc0
        e, el, cq = mass_veto.knot_mass_bounds(
            c, sc, th[:, seg], th[:, seg + 1], slope, lnpm, lpn,
            dens_m[5])
        if veto_details is not None:
            veto_details.update(m=m, wide=wide, e=e, el=el, cq=cq)
        mono = mass_veto.knot_veto(th, c, kc0, m, wide, e, el, cq, sc,
                                   total, veto_details)
        total = torch.where(mono, total, NEG)
    elif I["mass_veto"]:
        # (P / P_0) r g (1 / n_e) n_0 sign(P_0) as a product, as ll_body
        # forms it, and in the signed log form for a row one of whose
        # radii has n_e^2 not normal; np.gradient's pairs: central
        # differences inside, one-sided at the edges
        ne_inv, _, _, normal, q, _ = dens_r
        g = cg + (b_ - cg) * sfrac
        m = p_rel * r * g * ne_inv * (torch.sign(P0) * torch.sqrt(n0sq))
        wide = (~normal).any(dim=1, keepdim=True)
        if wide.any():
            m = torch.where(wide, _signed_log_mass(
                A["lnr"] + torch.log(g.abs()) + lnp - 0.5 * q,
                torch.sign(P0) * torch.sign(g)), m)
        sc.update(P0=P0, a=a_, bca=bca, bmc=b_ - cg, lnrp=lnrp)
        if veto_details is not None:
            veto_details.update(m=m, wide=wide)
        mono = mass_veto.gnfw_veto(th, c, m, wide, sc, total,
                                   veto_details)
        total = torch.where(mono, total, NEG)

    # SZ
    sep = I["sep"]
    t_sz = (vikh_T(r[:sep]) if vikh else
            _over_ne(press, dens_r)[:, :sep])
    t0 = (t_sz * A["wT0"]).sum(dim=1, keepdim=True)
    t_all = torch.cat([t0, t_sz], dim=1)                    # (B, sep+1)
    total = total + sz_chain_plain(press, t_all, cal, A)[:, None]
    di = (press * A["wint"]).sum(dim=1, keepdim=True) - A["mui"]
    total = total - 0.5 * di * di

    if I["has_xray"]:
        total = total + _xray_plain(
            th, c, dens, vikh_T if vikh else None,
            press_knots(A["KM"]) if knots else press_of(A["lnmid"])[0])
    total = torch.where(torch.isnan(total), NEG, total)
    return total[:, 0]


def _xray_plain(th, c: JointConsts, dens, vikh_T, press_m):
    """(B, 1) X-ray Cash term with its positivity veto: temperatures at
    the shell midpoints (``vikh_T``, else ``press_m`` / ne x 10^ratio), a
    two-tap count-rate lookup, projection, Cash; ``dens`` gives (1/n_e,
    n_e^2)."""
    A, I, F = c.arrays, c.ints, c.floats
    NEG = torch.tensor(-float("inf"), dtype=torch.float32, device=th.device)

    def col(role):
        return th[:, c.roles[role]:c.roles[role] + 1]

    Z, bscale = col("Z"), col("backscale")
    if I["has_ls"]:
        Z = Z * col("line_scale")
    midr = A["midr"]
    dens_m = dens(midr)
    ne2m = dens_m[1]
    if vikh_T is not None:
        Tm = vikh_T(midr)
    else:
        Tm = _over_ne(press_m, dens_m) * 10.0 ** col("log(T_X/T_{SZ})")
    tl = torch.log(_nanmax(Tm, 1e-30))
    pos = _nanclip((tl - F["t0g"]) * F["inv_dtg"], 0.0, F["pos_hi"])
    bad = torch.isnan(pos)
    pos = torch.where(bad, torch.zeros_like(pos), pos)
    k0 = torch.floor(pos)
    nT = I["nT"]
    w0 = torch.clamp(1.0 - (pos - k0).abs(), min=0.0)
    w1 = torch.clamp(1.0 - (pos - (k0 + 1.0)).abs(), min=0.0)
    k0i = k0.long()
    on1 = k0i + 1 < nT
    w1 = torch.where(on1, w1, torch.zeros_like(w1))
    k1i = torch.clamp(k0i + 1, max=nT - 1)
    # (B, n_band, n_sh) log-rates at Z=0 and Z=1
    l0 = w0[:, None, :] * A["LR0"][:, k0i].permute(1, 0, 2) \
        + w1[:, None, :] * A["LR0"][:, k1i].permute(1, 0, 2)
    l1 = w0[:, None, :] * A["LR1"][:, k0i].permute(1, 0, 2) \
        + w1[:, None, :] * A["LR1"][:, k1i].permute(1, 0, 2)
    ne2w = ne2m[:, None, :]
    e0 = torch.exp(l0) * (1.0 - Z)[:, :, None] * ne2w
    e1 = torch.exp(l1) * Z[:, :, None] * ne2w
    e0 = torch.where(bad[:, None, :], torch.full_like(e0, float("nan")), e0)
    proj = e0 @ A["volsT"] + e1 @ A["volsT"]                # (B, band, ann)
    pred = proj * A["sigf"] + bscale[:, :, None] * A["bgf"]
    cmf, ctf = A["cmf"], A["ctf"]
    okmin = ((pred > 0.0) | (cmf == 0.0)).flatten(1).all(dim=1, keepdim=True)
    safe = torch.where(pred > 0.0, pred, torch.ones_like(pred))
    cash = (cmf * (ctf * torch.log(safe) - safe)).flatten(1).sum(
        dim=1, keepdim=True)
    return torch.where(okmin, cash, NEG)


def _check_theta(theta: torch.Tensor, c: JointConsts):
    if theta.dim() != 2 or theta.shape[1] != c.ints["D"]:
        raise ValueError(f"theta must be (B, {c.ints['D']}), got "
                         f"{tuple(theta.shape)}")
    if theta.device != c.device:
        raise ValueError(f"theta on {theta.device}, constants on {c.device}")


def joint_ll(theta: torch.Tensor, c: JointConsts) -> torch.Tensor:
    """Batched log-posterior (B, D) -> (B,) float32.  A CPU tensor runs
    the plain version; a CUDA tensor launches kernel 1 (or raises)."""
    _check_theta(theta, c)
    if theta.device.type == "cpu":
        return joint_ll_plain(theta, c)
    from ._build import kernel_library, launch_checked

    th = theta.to(torch.float32).contiguous()
    B = th.shape[0]
    out = torch.empty(B, dtype=torch.float32, device=th.device)
    if B == 0:
        return out
    lib = kernel_library("joint_ll")
    launch_checked(
        "joint_ll", lib.launch_joint_ll, th.data_ptr(), B, out.data_ptr(),
        c.buf.data_ptr(), c.params.iv_ptr, c.params.fv_ptr,
        torch.cuda.current_stream(th.device).cuda_stream)
    joint_ll.launches += 1
    return out


joint_ll.launches = 0


def f64_pairs(reset: bool = False) -> int:
    """Mass-veto pairs the float64 tier decided (``ops.mass_veto``): over
    kernel 1's launches on the card (``csrc/joint_ll.cu``'s counter) and
    the plain version's calls on the CPU, since the last reset (``reset``
    clears both after reading)."""
    from ._build import f64_pairs as card

    n = card("joint_ll", reset) + mass_veto.F64_PAIRS[0]
    if reset:
        mass_veto.F64_PAIRS[0] = 0
    return n


def tier2_pairs() -> int:
    """Mass-veto pairs tier 1 left to tiers 2-3 (``ops.mass_veto``), over
    kernel 1's launches (a partial tile's padding rows, copies of its
    first, counted too) and the plain version's calls, never reset."""
    from ._build import tier2_pairs as card

    return card("joint_ll") + mass_veto.T2_PAIRS[0]


def joint_ll_flops(c: JointConsts) -> int:
    """Floating-point operations one walker's evaluation needs (FMA = 2,
    a transcendental ~4), counted from the shapes and the family's
    branches: the per-radius profiles, the mass veto, the two SZ
    products, the X-ray temperatures, taps, projection and Cash."""
    I = c.ints
    n_p, n_pix, n_d = I["n_press"], I["n_pix"], I["n_data"]
    n_sh, n_ann, n_b = I["n_sh"], I["n_ann"], I["n_band"]
    knots = I["p_fam"] == P_KNOTS
    press = 6 if knots else 20             # 2 products + exp; gNFW chain
    dens = 14 + (10 if I["d_fam"] == D_DOUBLE else 0)
    t_vikh = 22 if I["t_fam"] == T_VIKH else 0
    per_radius = press + dens + (0 if knots else 6)     # + the mass
    veto = (I["n_knots"] - 1) * (12 + dens) if knots and I["mass_veto"] \
        else 0
    sz = 2 * n_p * n_pix + 2 * n_pix * n_d + 12 * n_pix + 4 * n_d
    t_sz = I["sep"] * t_vikh
    xray = 0
    if I["has_xray"]:
        xray = (n_sh * (press + dens + (t_vikh or 6) + n_b * 14)
                + n_b * n_ann * (4 * n_sh + 8))
    return per_radius * n_p + veto + sz + t_sz + xray + 6 * I["D"]


def joint_ll_bytes(c: JointConsts, B: int) -> int:
    """Bytes a call must move: each input read once (theta and every
    constant), each output written once."""
    return 4 * (B * c.ints["D"] + c.buf.numel() + B)
