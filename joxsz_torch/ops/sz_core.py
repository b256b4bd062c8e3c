"""The fused SZ-likelihood core of a walker batch.

Replaces ``joxsz_tpu/ops/pallas_kernels.py::make_sz_core``.  Per walker,
from the pressure profile ``pp`` (n_press,), the temperatures ``t_all``
(n_pix,) = [T(0), T_SZ on the map radii] and the calibration:

    raw   = pp @ L^T
    conv  = lerp(y->mJy table, t_all)     end segments extrapolate
    prof  = raw * conv * calibration
    model = prof @ G^T
    ll    = -1/2 sum(((flux - model) * w)^2)

with ``w = 1/err`` and exactly 0 on NaN/inf flux or error and on zero
error (``sz_padded_data``).  A NaN temperature or pressure propagates to
``ll``; the caller turns it into -inf.  Conversion knots with zero
spacing give an infinite slope, as the reference's division does.

CUDA kernel: ``csrc/sz_core.cu`` over the device function
``csrc/joint_ll.cuh::sz_chain_tile`` that the joint-likelihood kernel
calls too; a block of 512 threads stages the constants in shared memory
once and walks tiles of 16 walkers, staging their ``pp`` and ``t_all``
rows; the k axis of ``pp @ L^T`` is split over eight warp pairs and
summed in a fixed order (``ksplit_matmul`` is the plain mirror), FP32
FMAs only (no tensor cores: a TF32 pass feeding chi^2 loses the digits
the likelihood needs), the conversion table as run-time data.  What
bounds it on the card: the two products (2 n_press n_pix + 2 n_pix
n_data operations per walker against ~(n_press + n_pix + 2) floats
moved), so operations.

``sz_core_plain`` is the same arithmetic in plain torch in the dtype it
is given; the wrapper ``sz_core`` runs it only for CPU tensors and
launches the kernel (float32) for CUDA tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .consts_layout import LaunchParams, check_conv_table, pack_arrays


def sz_padded_data(flux, flux_err):
    """``(flux, w)`` float64 with the SZ validity rule applied: a point
    whose flux or error is NaN/inf, or whose error is 0, gets flux 0 and
    weight 0 and so adds exactly zero to chi^2 (the reference's nansum,
    joxsz_funcs.py:479); every other point gets ``w = 1/err``.  The one
    implementation of the rule (``joxsz_tpu/ops/pallas_kernels.py::
    sz_padded_data`` without the 128-lane padding)."""
    flux = np.asarray(flux, dtype=np.float64)
    err = np.asarray(flux_err, dtype=np.float64)
    valid = np.isfinite(flux) & np.isfinite(err) & (err != 0)
    w = np.where(valid, 1.0 / np.where(valid, err, 1.0), 0.0)
    return np.where(valid, flux, 0.0), w


def conv_slopes(conv_T, conv_V):
    """Per-segment slope of the conversion table, 0 appended for the
    last knot (never selected: the segment index stops at n - 2)."""
    conv_T = np.asarray(conv_T, dtype=np.float64)
    conv_V = np.asarray(conv_V, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.append(np.diff(conv_V) / np.diff(conv_T), 0.0)


# k chunks of pp @ L^T in the kernel (KSPLIT in csrc/joint_ll.cuh)
KSPLIT = 8


def ksplit_matmul(pp, LT):
    """pp @ L^T summed as the kernel sums it: the k axis in KSPLIT chunks
    of ceil(n / KSPLIT), each chunk a product of its own, then the chunk
    sums combined as s_i += s_i+h for h = 4, 2, 1."""
    n = LT.shape[0]
    kc = -(-n // KSPLIT)
    s = [pp[:, i * kc:(i + 1) * kc] @ LT[i * kc:(i + 1) * kc]
         for i in range(KSPLIT)]
    h = KSPLIT // 2
    while h:
        s = [s[i] + s[i + h] for i in range(h)]
        h //= 2
    return s[0]


def sz_chain_plain(pp, t_all, cal, A: dict):
    """-chi^2/2 (B,) of the SZ chain on arrays ``A`` (LT, GT, flux, wres,
    convT, convV, convS) in the dtype of ``pp``; ``cal`` (B, 1)."""
    raw = ksplit_matmul(pp, A["LT"])                        # (B, n_pix)
    cidx = torch.zeros_like(t_all, dtype=torch.long)
    for k in range(1, A["convT"].shape[0] - 1):
        cidx = cidx + (t_all >= A["convT"][k]).long()
    conv = A["convV"][cidx] + (t_all - A["convT"][cidx]) * A["convS"][cidx]
    prof = raw * conv * cal
    model = prof @ A["GT"]
    resid = (A["flux"] - model) * A["wres"]
    return -0.5 * (resid * resid).sum(dim=1)


@dataclasses.dataclass
class SZCoreConsts:
    """Constants of the SZ core on one device: float64 arrays for the
    plain version, the packed float32 buffer for the kernel."""

    arrays64: dict
    arrays: dict          # float32 views into ``buf``
    buf: torch.Tensor
    ints: dict
    params: LaunchParams

    @property
    def device(self):
        return self.buf.device


def pack_sz_consts(op, conv_table, flux, flux_err, device) -> SZCoreConsts:
    dev = torch.device(device)
    t_tab, v_tab = (np.asarray(a, dtype=np.float64) for a in conv_table)
    check_conv_table(t_tab)
    f, w = sz_padded_data(flux, flux_err)
    arrs = {"LT": np.asarray(op.L, np.float64).T,
            "GT": np.asarray(op.G, np.float64).T, "flux": f, "wres": w,
            "convT": t_tab, "convV": v_tab,
            "convS": conv_slopes(t_tab, v_tab)}
    n_pix, n_press = np.shape(op.L)
    if arrs["GT"].shape != (n_pix, f.size):
        raise ValueError(f"G must be ({f.size}, {n_pix}), got "
                         f"{np.shape(op.G)}")
    buf, offsets, views = pack_arrays([arrs], dev)
    ints = dict(n_press=n_press, sep=n_pix - 1, n_pix=n_pix, n_data=f.size,
                n_conv=t_tab.size)
    return SZCoreConsts(
        arrays64={k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
                  for k, v in arrs.items()},
        arrays=views[0], buf=buf[0], ints=ints,
        params=LaunchParams(ints, None, offsets, {}))


def sz_core_plain(pp, t_all, calibration, c: SZCoreConsts) -> torch.Tensor:
    """Plain version: pp (B, n_press), t_all (B, n_pix), calibration (B,)
    -> (B,), in the dtype of ``pp``."""
    A = c.arrays if pp.dtype == torch.float32 else {
        k: v.to(pp.dtype) for k, v in c.arrays64.items()}
    return sz_chain_plain(pp, t_all.to(pp.dtype),
                          calibration.to(pp.dtype)[:, None], A)


def sz_core(pp, t_all, calibration, c: SZCoreConsts) -> torch.Tensor:
    """SZ core of a batch.  CPU tensors run the plain version in their
    own dtype; CUDA tensors launch the kernel in float32 (or raise)."""
    I = c.ints
    B = pp.shape[0]
    if pp.shape != (B, I["n_press"]) or t_all.shape != (B, I["n_pix"]) \
            or calibration.shape != (B,):
        raise ValueError(
            f"want pp (B, {I['n_press']}), t_all (B, {I['n_pix']}), "
            f"calibration (B,); got {tuple(pp.shape)}, "
            f"{tuple(t_all.shape)}, {tuple(calibration.shape)}")
    if pp.device != c.device:
        raise ValueError(f"pp on {pp.device}, constants on {c.device}")
    if pp.device.type == "cpu":
        return sz_core_plain(pp, t_all, calibration, c)
    from ._build import kernel_library, check_launch

    pp32, t32, cal32 = (t.to(torch.float32).contiguous()
                        for t in (pp, t_all, calibration))
    out = torch.empty(B, dtype=torch.float32, device=pp.device)
    if B == 0:
        return out
    lib = kernel_library("sz_core")
    err = lib.launch_sz_core(
        pp32.data_ptr(), t32.data_ptr(), cal32.data_ptr(), B, out.data_ptr(),
        c.buf.data_ptr(), c.params.iv_ptr, c.params.fv_ptr,
        torch.cuda.current_stream(pp.device).cuda_stream)
    check_launch(err, "sz_core")
    sz_core.launches += 1
    return out


sz_core.launches = 0


def make_sz_core(op, conv_table, flux, flux_err, device):
    """``sz_core(pp, t_all, calibration) -> ll`` for walker batches on
    ``device``, from the SZ operator (host numpy), the conversion table
    ``(T_keV, mJy per y)`` and the flux data."""
    consts = pack_sz_consts(op, conv_table, flux, flux_err, device)

    def core(pp, t_all, calibration):
        return sz_core(pp, t_all, calibration, consts)

    core.consts = consts
    return core


def sz_core_flops(c: SZCoreConsts) -> int:
    """Floating-point operations one walker needs (FMA = 2): the two
    products, the lerp and scaling per map radius, the residuals."""
    I = c.ints
    return (2 * I["n_press"] * I["n_pix"] + 2 * I["n_pix"] * I["n_data"]
            + 6 * I["n_pix"] + 4 * I["n_data"])


def sz_core_bytes(c: SZCoreConsts, B: int) -> int:
    """Bytes a call must move: pp, t_all, calibration and every constant
    read once, the result written once."""
    I = c.ints
    return 4 * (B * (I["n_press"] + I["n_pix"] + 2) + c.buf.numel())
