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
from .pressure import GNFWPressure
from .density import VikhlininDensity
from .temperature import UPPTemperature
from .mass import HSEMass
from .sz import SZData, sz_log_like
from .xray import XrayData, xray_log_like


@dataclasses.dataclass
class JointModel:
    """Components + data defining the joint posterior (gNFW pressure,
    single Vikhlinin density, UPP temperature)."""

    pressure: GNFWPressure
    density: VikhlininDensity
    temperature: UPPTemperature
    params: ParamSet
    sz_data: SZData
    xray_data: XrayData
    exclude_unphysical_mass: bool = True
    Z_name: str = "Z"

    def __post_init__(self):
        self.mass = HSEMass(self.pressure, self.density)

    def _mass_veto_ok(self, pars: dict, r_press_kpc) -> torch.Tensor:
        """(B,) physical-mass criterion (reference veto,
        joxsz_funcs.py:522-525): np.gradient of M(<r) strictly positive
        on the pressure grid — central differences inside, one-sided at
        the two edges (the unit-spacing gradient's sign)."""
        m = self.mass(pars, r_press_kpc)                 # (B, n)
        grad = torch.cat([m[:, 1:2] - m[:, 0:1],
                          (m[:, 2:] - m[:, :-2]) / 2.0,
                          m[:, -1:] - m[:, -2:-1]], dim=1)
        return (grad > 0.0).all(dim=1)

    def log_like_batch(self, theta: torch.Tensor) -> torch.Tensor:
        """Joint log-posterior (priors included) of a (B, D) batch ->
        (B,); NaN -> -inf so no NaN reaches a chain."""
        sz, xr = self.sz_data, self.xray_data
        pars = self.params.unpack(theta)
        total = self.params.log_prior(theta)
        total = total + self.density.log_prior(pars)
        if self.exclude_unphysical_mass:
            mono = self._mass_veto_ok(pars, sz.r_press_kpc)
            total = torch.where(mono, total,
                                torch.full_like(total, -float("inf")))
        total = total + xray_log_like(pars, xr, self.density,
                                      self.temperature, self.Z_name)
        total = total + sz_log_like(pars, sz, self.pressure,
                                    self.temperature)
        return torch.where(torch.isnan(total),
                           torch.full_like(total, -float("inf")), total)

    def log_like(self, theta: torch.Tensor) -> torch.Tensor:
        """Scalar log-posterior of one (D,) thawed vector."""
        return self.log_like_batch(theta[None])[0]


def build_reference_params(pressure: GNFWPressure, density: VikhlininDensity,
                           temperature: UPPTemperature, Z_solar: float = 0.3,
                           edges_logkpc: np.ndarray | None = None
                           ) -> ParamSet:
    """The reference's 13-parameter configuration (reference
    joxsz_main.py:128-175): Vikhlinin density (alpha, gamma frozen; rc
    reset; eps bound widened), flat metallicity, gNFW pressure (c
    frozen), thawed T-ratio, Gaussian-prior backscale and calibration.
    Same construction as ``joxsz_tpu/models/joint.py``."""
    pars = density.default_params()
    pars.update(temperature.default_params())
    pars.update(OrderedDict([
        ("Z", Param(Z_solar, 0.0, 1.0, unit="solar")),
        # spectral-line systematic nuisance, frozen at 1 (thawing it is a
        # later slice of the port)
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
    pars.freeze("c")
    pars.thaw("log(T_X/T_{SZ})")
    return pars
