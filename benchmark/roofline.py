"""The yardstick's operation and byte counts and the H100's peaks.

``flops_per_eval`` is a frozen copy of the port's count of one walker's
log-posterior evaluation (``joxsz_torch/ops/joint_kernel.py::
joint_ll_flops`` when the benchmark was written: FMA = 2, a
transcendental ~4), taken from the shapes of the benchmark's own
reference model, so that the yardstick does not move with the code it
measures.  The least time of an evaluation charges the projection
``pp @ L^T`` (``2 n_press n_pix``) at the TF32 tensor rate and every
other operation at the float32 rate: a kernel that moves the projection
onto the tensor cores still reads at most 100%.  Bytes count each input
of the model read once (theta and the reference's constants) and each
output written once."""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet, dense, at the 700 W power limit
PEAK_F32_S = 67e12          # float32 FLOP/s outside the tensor cores
PEAK_TF32_S = 495e12        # TF32 tensor FLOP/s
PEAK_BYTES_S = 3.35e12      # HBM3 bytes/s


def model_shapes(model) -> dict:
    """The sizes the counts read, from a reference model
    (``reference.model.models.JointModel``)."""
    sz, xr = model.sz_data, model.xray_data
    p = model.params.thawed
    return {
        "n_press": int(sz.r_press_kpc.numel()), "n_pix": int(sz.L.shape[0]),
        "n_data": int(sz.G.shape[0]), "sep": int(sz.sep),
        "n_sh": int(xr.vols_norm.shape[1]), "n_ann": int(xr.vols_norm.shape[0]),
        "n_band": int(xr.counts_mask.shape[0]),
        "nT": int(xr.table.Tlog.numel()), "n_conv": int(sz.conv_T.numel()),
        "D": len(p),
        "knots": sum(1 for n in p if n.startswith("logP_")),
        "t_vikh": "T_0" in p, "double": "log(n_{02})" in p,
        "mass_veto": bool(model.exclude_unphysical_mass),
    }


def flops_split(s: dict) -> tuple[int, int]:
    """(projection FLOPs, all other FLOPs) of one evaluation."""
    n_p, n_pix, n_d = s["n_press"], s["n_pix"], s["n_data"]
    n_sh, n_ann, n_b = s["n_sh"], s["n_ann"], s["n_band"]
    knots = s["knots"] > 0
    press = 6 if knots else 20
    dens = 14 + (10 if s["double"] else 0)
    t_vikh = 22 if s["t_vikh"] else 0
    per_radius = press + dens + (0 if knots else 6)
    veto = (s["knots"] - 1) * (12 + dens) if knots and s["mass_veto"] else 0
    proj = 2 * n_p * n_pix
    sz = 2 * n_pix * n_d + 12 * n_pix + 4 * n_d
    xray = (n_sh * (press + dens + (t_vikh or 6) + n_b * 14)
            + n_b * n_ann * (4 * n_sh + 8))
    rest = (per_radius * n_p + veto + sz + s["sep"] * t_vikh + xray
            + 6 * s["D"])
    return proj, rest


def flops_per_eval(s: dict) -> int:
    """Every FLOP of one evaluation (the port's count)."""
    return sum(flops_split(s))


def const_bytes(s: dict) -> int:
    """Bytes of the model's inputs besides theta, each read once: the SZ
    operator, data and conversion table, and the X-ray projection, the
    per-annulus arrays, the shells and the count-rate table (float32)."""
    n_p, n_pix, n_d = s["n_press"], s["n_pix"], s["n_data"]
    n_sh, n_ann, n_b = s["n_sh"], s["n_ann"], s["n_band"]
    sz = n_pix * n_p + n_d * n_pix + 2 * n_d + s["sep"] + 2 * n_p \
        + 2 * s["n_conv"]
    xray = n_ann * n_sh + 5 * n_b * n_ann + n_sh + s["nT"] * (1 + 2 * n_b)
    return 4 * (sz + xray)


def eval_seconds(s: dict) -> float:
    """Least device time of one evaluation by its operations: the
    projection at the TF32 rate, the rest at the float32 rate."""
    proj, rest = flops_split(s)
    return proj / PEAK_TF32_S + rest / PEAK_F32_S


def launch_least_seconds(s: dict, n_evals: int, n_rows: int) -> float:
    """Least time of a launch that makes ``n_evals`` evaluations over
    ``n_rows`` walkers: its operations, or its bytes (the constants once,
    each walker's state (D + 2 floats) read once and written once),
    whichever is longer."""
    nbytes = const_bytes(s) + 2 * 4 * n_rows * (s["D"] + 2)
    return max(n_evals * eval_seconds(s), nbytes / PEAK_BYTES_S)
