"""Joint SZ + X-ray model: one batched log-posterior.

Torch counterpart of ``joxsz_tpu/models/joint.py`` (reference
monkey-patched ``getLikelihood``, joxsz_funcs.py:507-546): parameter
priors, hydrostatic-mass monotonicity veto, X-ray predicted counts with
positivity veto, Cash term and SZ chi^2 as one function of a (B, D)
batch of thawed vectors.  The reference's early -inf returns are
``torch.where`` masks so the whole batch evaluates at once; it runs in
float64 or float32 on any device and is differentiable by autograd (the
MLE uses that).  This is the port's reference likelihood; the kernel of
``ops.joint_kernel`` is held against it.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from .params import ParamSet, Param, gaussian_param
from .density import VikhlininDensity
from .mass import HSEMass
from .sz import SZData, sz_brightness, sz_log_like
from .xray import XrayData, predicted_counts, xray_log_like


@dataclasses.dataclass
class JointModel:
    """Components + data defining the joint posterior: pressure (gNFW or
    knots), Vikhlinin density (single or double), temperature (UPP or
    Vikhlinin).  ``xray_data`` None is an SZ-only fit (the preprofit
    mode, BASELINE config #1)."""

    pressure: object
    density: VikhlininDensity
    temperature: object
    params: ParamSet
    sz_data: SZData
    xray_data: XrayData | None = None
    exclude_unphysical_mass: bool = True
    Z_name: str = "Z"

    def __post_init__(self):
        self.mass = HSEMass(self.pressure, self.density)

    def to(self, device, dtype) -> "JointModel":
        """A copy of the model with every data tensor on ``device`` in
        ``dtype`` (the components hold no tensors)."""
        return dataclasses.replace(
            self, sz_data=_moved(self.sz_data, device, dtype),
            xray_data=(None if self.xray_data is None
                       else _moved(self.xray_data, device, dtype)))

    def _mass_veto_ok(self, pars: dict, r_press_kpc) -> torch.Tensor:
        """(B,) physical-mass criterion (reference veto,
        joxsz_funcs.py:522-525), per pressure family as
        ``joxsz_tpu/models/joint.py::_mass_veto_ok``.

        Smooth pressure: np.gradient of M(<r) strictly positive on the
        pressure grid — central differences inside, one-sided at the two
        edges (the unit-spacing gradient's sign).  Knot pressure: the
        segment-averaged mass at one log-midpoint per segment strictly
        increasing and ending positive (the dense-grid check would reject
        the interpolant's kinks)."""
        rv = getattr(self.pressure, "mass_veto_radii", None)
        if rv is not None:
            m = self.mass(pars, torch.as_tensor(
                rv(), dtype=r_press_kpc.dtype, device=r_press_kpc.device))
            return (m[:, 1:] > m[:, :-1]).all(dim=1) & (m[:, -1] > 0.0)
        m = self.mass(pars, r_press_kpc)                 # (B, n)
        grad = torch.cat([m[:, 1:2] - m[:, 0:1],
                          (m[:, 2:] - m[:, :-2]) / 2.0,
                          m[:, -1:] - m[:, -2:-1]], dim=1)
        return (grad > 0.0).all(dim=1)

    def _prior(self, theta, pars, sz: SZData) -> torch.Tensor:
        """(B,) prior factor: the box and Gaussian priors, the density's
        r_c <= r_s prior and the physical-mass veto."""
        total = self.params.log_prior(theta)
        total = total + self.density.log_prior(pars)
        if self.exclude_unphysical_mass:
            mono = self._mass_veto_ok(pars, sz.r_press_kpc)
            total = torch.where(mono, total,
                                torch.full_like(total, -float("inf")))
        return total

    def _rest(self, theta, pars, sz: SZData,
              xr: XrayData | None) -> torch.Tensor:
        """Everything but the SZ chi^2: the prior factor and (with X-ray
        data) the X-ray Cash term, (B,)."""
        total = self._prior(theta, pars, sz)
        if xr is None:
            return total
        return total + xray_log_like(pars, xr, self.density,
                                     self.temperature, self.Z_name)

    def log_like_batch(self, theta: torch.Tensor,
                       sz_data: SZData | None = None,
                       xray_data: XrayData | None = None) -> torch.Tensor:
        """Joint log-posterior (priors included) of a (B, D) batch ->
        (B,); NaN -> -inf so no NaN reaches a chain.  ``sz_data`` /
        ``xray_data`` override the bound datasets (one cluster of a
        stack, ``models.multicluster``)."""
        sz = sz_data if sz_data is not None else self.sz_data
        xr = xray_data if xray_data is not None else self.xray_data
        pars = self.params.unpack(theta)
        total = self._rest(theta, pars, sz, xr)
        total = total + sz_log_like(pars, sz, self.pressure,
                                    self.temperature)
        return torch.where(torch.isnan(total),
                           torch.full_like(total, -float("inf")), total)

    def log_like(self, theta: torch.Tensor) -> torch.Tensor:
        """Scalar log-posterior of one (D,) thawed vector."""
        return self.log_like_batch(theta[None])[0]

    # -- prior/likelihood decomposition (the evidence ladder) ---------------
    # ``log_like_batch`` is the full posterior density; the evidence
    # ladder (sampling/evidence.py) samples prior * L^beta and needs the
    # two factors apart.  The split is exact: log_like_batch ==
    # log_prior_only + log_data_like wherever the prior is finite.

    def log_prior_only(self, theta: torch.Tensor,
                       sz_data: SZData | None = None) -> torch.Tensor:
        """(B,) prior factor of a (B, D) batch: box and Gaussian priors,
        the density's r_c <= r_s prior and the physical-mass veto (support
        restrictions are prior semantics: the evidence is defined against
        this veto-restricted prior); NaN -> -inf."""
        sz = sz_data if sz_data is not None else self.sz_data
        total = self._prior(theta, self.params.unpack(theta), sz)
        return torch.where(torch.isnan(total),
                           torch.full_like(total, -float("inf")), total)

    def log_data_like(self, theta: torch.Tensor,
                      sz_data: SZData | None = None,
                      xray_data: XrayData | None = None) -> torch.Tensor:
        """(B,) data factor of a (B, D) batch: the X-ray Cash term (with
        its predicted-counts positivity veto) and the SZ chi^2; NaN ->
        -inf."""
        sz = sz_data if sz_data is not None else self.sz_data
        xr = xray_data if xray_data is not None else self.xray_data
        pars = self.params.unpack(theta)
        total = sz_log_like(pars, sz, self.pressure, self.temperature)
        if xr is not None:
            total = xray_log_like(pars, xr, self.density, self.temperature,
                                  self.Z_name) + total
        return torch.where(torch.isnan(total),
                           torch.full_like(total, -float("inf")), total)

    def log_like_batch_fused(self, conv_table, flux_data, op):
        """Batched joint log-posterior with the SZ core (two products,
        the conversion lerp and chi^2) as the one fused kernel of
        ``ops.sz_core``: the profiles ``pp`` and ``t_all`` = [w_T0 .
        t_prof, t_prof], the priors, vetoes, X-ray Cash and integrated-Y
        terms stay plain torch in the session's dtype.  Built from the
        conversion table, the flux data ``(r, flux, err)`` and the host
        SZ operator; returns ``batch_ll((B, D)) -> (B,)``.  Equal to
        ``log_like_batch`` up to the core's float32 on the card."""
        from ..ops.sz_core import make_sz_core

        sz = self.sz_data
        core = make_sz_core(op, conv_table, flux_data[1], flux_data[2],
                            device=sz.L.device)
        r, sep = sz.r_press_kpc, sz.sep

        def batch_ll(theta: torch.Tensor) -> torch.Tensor:
            pars = self.params.unpack(theta)
            pp = self.pressure(pars, r)
            t_prof = self.temperature.t_sz(pars, r[:sep])
            t_all = torch.cat([(t_prof @ sz.w_T0)[:, None], t_prof], dim=1)
            cal = pars["calibration"]
            cal = cal[:, 0] if torch.is_tensor(cal) else \
                torch.full_like(pp[:, 0], cal)
            total = self._rest(theta, pars, sz, self.xray_data)
            if sz.calc_integ:
                cint = pp @ sz.integ_w
                total = total - 0.5 * ((cint - sz.integ_mu)
                                       / sz.integ_sig) ** 2
            total = total + core(pp, t_all, cal).to(total.dtype)
            return torch.where(torch.isnan(total),
                               torch.full_like(total, -float("inf")), total)

        batch_ll.core = core
        return batch_ll

    # -- diagnostics / mock data --------------------------------------------
    def sz_profile(self, theta: torch.Tensor) -> torch.Tensor:
        """(B, n_pix) model surface brightness (mJy/beam) of a (B, D)
        batch."""
        return sz_brightness(self.params.unpack(theta), self.sz_data,
                             self.pressure, self.temperature)

    def xray_profiles(self, theta: torch.Tensor) -> torch.Tensor:
        """(B, n_band, n_ann) predicted counts of a (B, D) batch."""
        return predicted_counts(self.params.unpack(theta), self.xray_data,
                                self.density, self.temperature, self.Z_name)


def _moved(data, device, dtype):
    """A frozen data container (``SZData``, ``XrayData``,
    ``CountRateTable``) with its tensors, nested ones too, moved."""
    kw = {}
    for f in dataclasses.fields(data):
        v = getattr(data, f.name)
        if torch.is_tensor(v):
            kw[f.name] = v.to(device=device, dtype=dtype)
        elif dataclasses.is_dataclass(v):
            kw[f.name] = _moved(v, device, dtype)
    return dataclasses.replace(data, **kw)


def build_reference_params(pressure, density: VikhlininDensity, temperature,
                           Z_solar: float = 0.3,
                           edges_logkpc: np.ndarray | None = None
                           ) -> ParamSet:
    """The reference's parameter configuration (reference
    joxsz_main.py:128-175): Vikhlinin density (alpha, gamma frozen; rc
    reset; eps bound widened), flat metallicity, the pressure (gNFW with
    c frozen, or the knot values), the temperature (thawed T-ratio for
    UPP, or the six Vikhlinin parameters), Gaussian-prior backscale and
    calibration; 13 thawed for the flagship.  Same construction as
    ``joxsz_tpu/models/joint.py``."""
    pars = density.default_params()
    pars.update(temperature.default_params())
    pars.update(OrderedDict([
        ("Z", Param(Z_solar, 0.0, 1.0, unit="solar")),
        # spectral-line systematic nuisance: scales the metal-line part of
        # the count-rate table; frozen at 1 unless --line-systematic
        ("line_scale", Param(1.0, 0.0, 2.5, frozen=True, prior="gauss",
                             prior_mu=1.0, prior_sigma=0.25)),
    ]))
    pars.update(pressure.default_params())
    pars.update(OrderedDict([
        ("backscale", gaussian_param(1.0, 1.0, 0.1)),
        ("calibration", gaussian_param(1.0, 1.0, 0.07)),
    ]))

    pars.freeze(r"\gamma", 3.0)
    pars["log(r_c)"].val = 2.0
    if edges_logkpc is not None:
        # reference bound tightening (joxsz_main.py:160-161), keeping the
        # default values strictly inside the tightened box and r_c <= r_s
        ceil = float(edges_logkpc[-2])
        for nm in ("log(r_c)", "log(r_s)"):
            pars[nm].maxval = ceil
            if pars[nm].val >= ceil:
                pars[nm].val = ceil - 0.05 * (ceil - pars[nm].minval)
        rc, rs = pars["log(r_c)"], pars["log(r_s)"]
        if rc.val > rs.val:
            rc.val = max(rc.minval, rs.val - 0.05 * (ceil - rc.minval))
            if rc.val >= rs.val:
                rs.val = rc.val + 0.5 * (ceil - rc.val)
    pars[r"\epsilon"].maxval = 10.0
    pars.freeze(r"\alpha", 0.0)
    if "c" in pars:                 # gNFW inner slope (no knots)
        pars.freeze("c")
    if "log(T_X/T_{SZ})" in pars:   # UPP temperature only
        pars.thaw("log(T_X/T_{SZ})")
    return pars
