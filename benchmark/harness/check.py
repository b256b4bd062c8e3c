"""The comparison that decides ``correct``: the program's stored
log-posteriors against the reference's at the same rows, the sampler's
law against the reference's expectation of it, and whether the walkers
moved at all over the window.

* ``lp_gap``: the widest |lp_program - lp_reference| over the checked
  rows (log-posterior units; a row the reference vetoes, or that the
  program stored as non-finite, reads infinite);
* ``move_acc_z``: for each rung (a survey: all clusters together), the
  share of stretch moves the program accepted over the window against
  the share the reference expects of the stretch law at the window's
  states: the mean over checked rows of min(1, z^(D-1) exp(beta (lp(y)
  - lp(x)))) over proposals drawn from the row (a partner of the row's
  other half, z ~ 1/sqrt(z) on [1/a, a]), both log-posteriors the
  reference's; the widest gap over the rungs in standard errors of the
  two shares;
* ``swap_acc_z`` (tempered, K > 1): for each rung boundary, the share of
  swap pairs the program accepted over the window against the mean of
  min(1, exp((beta_k - beta_k+1)(lp_hot - lp_cold))) over every pair of
  the two rungs' final states; the widest gap in standard errors;
* ``stuck_share``: the share of walkers that end the window (a survey:
  each job) where they started it."""

from __future__ import annotations

import numpy as np

from ..reference.lp import log_posterior


def lp_gap(lp_program: np.ndarray, lp_ref: np.ndarray) -> float:
    ok = np.isfinite(lp_program) & np.isfinite(lp_ref)
    if not ok.all():
        return float("inf")
    return float(np.max(np.abs(lp_program.astype(np.float64) - lp_ref)))


def accept_prob(lp_x, lp_y, log_z_term, beta) -> np.ndarray:
    """min(1, exp(log_z_term + beta (lp_y - lp_x))): a move to a vetoed
    point is never taken, a move off one always."""
    with np.errstate(invalid="ignore", over="ignore"):
        log_r = log_z_term + beta * (lp_y - lp_x)
    p = np.exp(np.minimum(log_r, 0.0))
    return np.where(np.isfinite(lp_y), np.nan_to_num(p, nan=1.0), 0.0)


def gap_z(program: float, decisions: float, ref: float,
          se_ref: float) -> float:
    """|program - ref| in standard errors: the reference's, and the
    program's share as a binomial one over its decisions."""
    se = np.hypot(se_ref, np.sqrt(max(program * (1.0 - program), 0.0)
                                  / max(decisions, 1.0)))
    gap = abs(program - ref)
    return float(gap / se) if se > 0 else (0.0 if gap == 0 else np.inf)


def move_readings(moves, ref_x, ref_y, D: int) -> tuple[float, list]:
    """Each group's expected share: the mean over its checked rows of
    the mean acceptance of the row's proposals, with the standard error
    of that mean over the rows."""
    p = accept_prob(ref_x, ref_y, (D - 1) * np.log(moves.z), moves.beta)
    zs, pairs = [], []
    for g, (prog, dec) in enumerate(zip(moves.program, moves.decisions)):
        sel = moves.group == g
        base, inv = np.unique(moves.base[sel], return_inverse=True)
        per_row = np.bincount(inv, p[sel]) / np.bincount(inv)
        ref = float(per_row.mean())
        se = float(per_row.std(ddof=1) / np.sqrt(len(base)))
        zs.append(gap_z(float(prog), float(dec), ref, se))
        pairs.append([float(prog), ref, se])
    return max(zs), pairs


def swap_readings(swaps, ref_lp) -> tuple[float, list]:
    zs, pairs = [], []
    for kk, (prog, dec) in enumerate(zip(swaps.program, swaps.decisions)):
        lc = ref_lp[swaps.rungs[kk]][:, None]
        lh = ref_lp[swaps.rungs[kk + 1]][None, :]
        p = accept_prob(lc, lh, 0.0, swaps.db[kk])
        W = p.shape[0]
        ref = float(p.mean())
        # a two-sample U statistic: the variance of its two projections
        se = np.sqrt((p.mean(1).var(ddof=1) + p.mean(0).var(ddof=1)) / W)
        zs.append(gap_z(float(prog), float(dec), ref, float(se)))
        pairs.append([float(prog), ref, float(se)])
    return max(zs), pairs


def readings(traffic_jobs, device, tf32: bool = False) -> dict:
    """The numbers compared for a run whose window has closed, and, not
    compared, each group's accepted shares as [program, reference, the
    reference's standard error]."""
    rows, moves, swaps, stuck = traffic_jobs.check_rows()
    cfg = traffic_jobs.cfg_path
    ref = log_posterior(cfg, rows.theta, flux=rows.flux,
                        counts=rows.counts, device=device)
    if tf32:
        # the control: the reference in TF32 put in the program's place
        prog = log_posterior(cfg, rows.theta, flux=rows.flux,
                             counts=rows.counts, device=device, tf32=True)
    else:
        prog = rows.lp
    data = ({} if rows.flux is None else
            {"flux": rows.flux[moves.base],
             "counts": rows.counts[moves.base]})
    ref_y = log_posterior(cfg, moves.theta, device=device, **data)
    out = {"lp_gap": lp_gap(prog, ref), "stuck_share": stuck,
           "rows": int(len(ref) + len(ref_y))}
    out["move_acc_z"], out["move_acc"] = move_readings(
        moves, ref[moves.base], ref_y, rows.theta.shape[1])
    if swaps is not None:
        out["swap_acc_z"], out["swap_acc"] = swap_readings(swaps, ref)
    return out


def verdict(read: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and, for each number, ``{"value", "limit"}``: every
    number at or below its limit (a number the run could not read
    counts as infinite)."""
    out = {k: {"value": read.get(k, float("inf")), "limit": limits[k]}
           for k in limits}
    return all(v["value"] <= v["limit"] for v in out.values()), out
