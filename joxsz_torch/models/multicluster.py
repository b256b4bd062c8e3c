"""Multi-cluster batched fitting: C clusters' data with a leading axis.

Torch counterpart of ``joxsz_tpu/models/multicluster.py``.  The data
containers (``SZData``/``XrayData``) of C clusters stack into one
container whose tensors carry a leading cluster axis (float fields such as
``integ_mu`` become (C,) tensors; static fields such as ``sep`` and
``calc_integ`` must agree), and

    make_multicluster_log_like(model, sz_stack, xray_stack)

maps a (C, W, D) parameter block to (C, W) log-posteriors, each cluster's
W walkers as one batch against that cluster's own data.  The JAX file has
two XLA lowerings of this function (nested vmap and a flat widened GEMM);
here there is one implementation, and both are held against it.

The clusters must share array shapes (map geometry, annuli and band
counts); group heterogeneous surveys by shape and run one stack per
group (``joxsz_torch.survey``).  An SZ-only model has no X-ray stack.
"""

from __future__ import annotations

import dataclasses

import torch

from .sz import SZData
from .xray import XrayData


def _stack(datas: list):
    """Stack same-type dataclass instances field by field along a new
    axis 0: tensors stack, nested dataclasses recurse, python floats
    become a (C,) float64 tensor, anything else (ints, bools) is static
    and must agree."""
    first = datas[0]
    dev = next(getattr(first, f.name).device
               for f in dataclasses.fields(first)
               if torch.is_tensor(getattr(first, f.name)))
    out = {}
    for f in dataclasses.fields(first):
        vals = [getattr(d, f.name) for d in datas]
        v0 = vals[0]
        if torch.is_tensor(v0):
            out[f.name] = torch.stack(vals)
        elif dataclasses.is_dataclass(v0):
            out[f.name] = _stack(vals)
        elif isinstance(v0, float):
            out[f.name] = torch.tensor(vals, dtype=torch.float64, device=dev)
        else:
            if any(v != v0 for v in vals):
                raise ValueError(f"static field {f.name!r} differs across "
                                 f"the stack: {vals}")
            out[f.name] = v0
    return type(first)(**out)


def unstack(stack, c: int):
    """Cluster ``c`` of a stacked container, as a single-cluster one (the
    inverse of stacking: tensors indexed, (C,) float tensors back to
    floats)."""
    ref = {f.name: f for f in dataclasses.fields(stack)}
    out = {}
    for name, f in ref.items():
        v = getattr(stack, name)
        if dataclasses.is_dataclass(v):
            out[name] = unstack(v, c)
        elif torch.is_tensor(v):
            out[name] = float(v[c]) if f.type in ("float", float) else v[c]
        else:
            out[name] = v
    return type(stack)(**out)


def stack_sz_data(datas: list[SZData]) -> SZData:
    if len({d.sep for d in datas}) != 1:
        raise ValueError("clusters must share map geometry (sep differs)")
    if len({bool(d.calc_integ) for d in datas}) != 1:
        raise ValueError(
            "clusters mix calc_integ=True and False — the integrated-Y "
            "option is a static flag and must be uniform across a stack")
    return _stack(datas)


def stack_xray_data(datas: list[XrayData]) -> XrayData:
    return _stack(datas)


def n_clusters(stack) -> int:
    return stack.L.shape[0] if isinstance(stack, SZData) \
        else stack.counts_mask.shape[0]


def make_multicluster_log_like(model, sz_stack: SZData | None,
                               xray_stack: XrayData | None):
    """(C, W, D) parameter block -> (C, W) log-posteriors.

    ``model`` (a single-cluster ``JointModel``) provides components and
    priors; the stacks provide each cluster's observations.  A stack is
    None exactly where the model has no data of that probe bound (an
    SZ-only model takes ``xray_stack=None``; every model has SZ data): a
    None stack beside bound data would have to guess between reusing the
    one bound dataset for every cluster and dropping the probe, so it is
    refused, as ``joxsz_tpu/models/multicluster.py`` refuses it.  Every model family
    evaluates through ``model.log_like_batch``, one cluster at a time;
    the JAX package's two lowerings (nested vmap, flat widened GEMM) give
    the numbers this one function gives."""
    if sz_stack is None:
        raise ValueError("pass both stacked SZData (stack_sz_data) and "
                         "stacked XrayData: every model has SZ data bound")
    if xray_stack is None and model.xray_data is not None:
        raise ValueError(
            "pass both stacked SZData and stacked XrayData "
            "(stack_xray_data) where the model has both probes bound: "
            "xray_stack is None but the model has X-ray data bound (build "
            "the model SZ-only to fit the SZ data alone)")
    C = n_clusters(sz_stack)
    if xray_stack is not None and n_clusters(xray_stack) != C:
        raise ValueError(f"{C} SZ clusters but {n_clusters(xray_stack)} "
                         "X-ray clusters")
    szs = [unstack(sz_stack, c) for c in range(C)]
    xrs = ([None] * C if xray_stack is None
           else [unstack(xray_stack, c) for c in range(C)])

    def batched(thetas: torch.Tensor) -> torch.Tensor:
        if thetas.dim() != 3 or thetas.shape[0] != C:
            raise ValueError(f"thetas must be ({C}, W, D), got "
                             f"{tuple(thetas.shape)}")
        return torch.stack([
            model.log_like_batch(thetas[c], sz_data=szs[c], xray_data=xrs[c])
            for c in range(C)])

    return batched
