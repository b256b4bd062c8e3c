"""Parameter system: named parameters, box/Gaussian priors, flat packing.

Torch counterpart of ``joxsz_tpu/models/params.py`` (which replaces
mbproj2's ``Param``/``ParamGaussian`` and the ``Fit.thawed`` machinery,
reference joxsz_funcs.py:213-246, joxsz_main.py:151-188).

Parameter *metadata* (bounds, frozen flags, units, prior kind) lives in an
ordered ``ParamSet`` built once on the host; samplers work on a flat
(B, D) tensor of thawed values.  ``ParamSet.unpack`` maps it to
name -> (B,) column (python float for frozen entries) and ``log_prior``
evaluates the box + Gaussian terms for the whole batch; out-of-box rows
get -inf so every walker keeps static shapes.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Iterable

import numpy as np
import torch


@dataclasses.dataclass
class Param:
    """One model parameter. ``prior='box'`` gives a uniform prior inside
    [minval, maxval]; ``prior='gauss'`` adds -0.5((x-mu)/sigma)^2 (optionally
    still bounded if minval/maxval set)."""

    val: float
    minval: float = -1e99
    maxval: float = 1e99
    unit: str = "."
    frozen: bool = False
    prior: str = "box"
    prior_mu: float | None = None
    prior_sigma: float | None = None


def gaussian_param(val: float, mu: float, sigma: float, unit: str = ".",
                   frozen: bool = False) -> Param:
    return Param(val=val, unit=unit, frozen=frozen, prior="gauss",
                 prior_mu=mu, prior_sigma=sigma)


class ParamSet:
    """Ordered parameter collection with flat-vector views."""

    def __init__(self, params: OrderedDict[str, Param] | Iterable):
        self._params: OrderedDict[str, Param] = OrderedDict(params)
        self._refresh()

    def _refresh(self):
        self.names = list(self._params)
        self.thawed = [n for n, p in self._params.items() if not p.frozen]
        self._thawed_idx = {n: i for i, n in enumerate(self.thawed)}
        th = [self._params[n] for n in self.thawed]

        # sentinel wide bounds become inf so a float32 cast cannot overflow
        def _lo(p):
            v = p.minval if p.minval is not None else -np.inf
            return -np.inf if v <= -1e30 else v

        def _hi(p):
            v = p.maxval if p.maxval is not None else np.inf
            return np.inf if v >= 1e30 else v

        self.lo = np.array([_lo(p) for p in th])
        self.hi = np.array([_hi(p) for p in th])
        self.is_gauss = np.array([p.prior == "gauss" for p in th])
        self.mu = np.array([p.prior_mu if p.prior == "gauss" else 0.0
                            for p in th])
        self.sigma = np.array([p.prior_sigma if p.prior == "gauss" else 1.0
                               for p in th])

    def __getitem__(self, name: str) -> Param:
        return self._params[name]

    def __contains__(self, name: str) -> bool:
        return name in self._params

    def update(self, other) -> "ParamSet":
        src = other._params if isinstance(other, ParamSet) else other
        self._params.update(src)
        self._refresh()
        return self

    def freeze(self, name: str, val: float | None = None):
        if val is not None:
            self._params[name].val = val
        self._params[name].frozen = True
        self._refresh()

    def thaw(self, name: str):
        self._params[name].frozen = False
        self._refresh()

    @property
    def ndim(self) -> int:
        return len(self.thawed)

    def thawed_values(self) -> np.ndarray:
        return np.array([self._params[n].val for n in self.thawed])

    def set_thawed_values(self, theta):
        for n, v in zip(self.thawed, np.asarray(theta)):
            self._params[n].val = float(v)

    def table_rows(self) -> list[tuple[str, float, str, bool]]:
        """(name, value, unit, frozen) rows for summaries."""
        return [(n, p.val, p.unit, p.frozen) for n, p in self._params.items()]

    def unpack(self, theta: torch.Tensor) -> dict:
        """(B, D) thawed tensor -> name -> (B, 1) column or python float,
        so every value broadcasts against (B, n_radius) profiles."""
        out = {}
        for name, p in self._params.items():
            if p.frozen:
                out[name] = p.val
            else:
                i = self._thawed_idx[name]
                out[name] = theta[:, i:i + 1]
        return out

    def log_prior(self, theta: torch.Tensor) -> torch.Tensor:
        """Box + Gaussian log-prior of a (B, D) batch -> (B,); -inf
        outside any box."""
        kw = dict(dtype=theta.dtype, device=theta.device)
        lo = torch.as_tensor(self.lo, **kw)
        hi = torch.as_tensor(self.hi, **kw)
        inside = ((theta >= lo) & (theta <= hi)).all(dim=1)
        z = (theta - torch.as_tensor(self.mu, **kw)) / torch.as_tensor(
            self.sigma, **kw)
        isg = torch.as_tensor(self.is_gauss, device=theta.device)
        gauss = torch.where(isg, -0.5 * z * z,
                            torch.zeros_like(z)).sum(dim=1)
        return torch.where(inside, gauss, torch.full_like(gauss,
                                                          -float("inf")))
