"""How often the posterior sits on the mass veto's float32 resolution, and
how often each of the veto's exact tiers runs there.

Runs the step kernel's plain version (``ops.step_kernel.stretch_steps`` on
CPU tensors) at K=4, W=1024 on the synthetic CL J1226 dataset (seed 11)
from a 1% cloud around the truth, and after every 20 steps counts, per
rung, the walkers the float64 model keeps whose mass veto holds a pair of
masses (np.gradient's pairs on the pressure grid) closer than a relative
difference ``eps`` of the larger mass: pairs a float32 comparison
cannot be sure of.  Beside that table it counts what the veto's tiers
(``ops/mass_veto.py``) do, on the walkers of the state (per rung: walkers
with a pair the float32 product form's bound cannot decide, pairs the
float32 difference form cannot decide either) and on the proposals the
20 steps evaluated (per half-step of K x W/2 proposals: the half-steps and
the tiles of 16 proposals holding a pair for tiers 2-3, the pairs that
reached the float64 tier).  The kernels run tiers 2-3 on one warp per such
tile; the float64 tier's latency is what a half-step pays where it runs.

    python3 scripts/torch_veto_near_ties.py [--steps 120]
"""
import argparse
import pathlib
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

EPS = (1e-6, 3e-6, 1e-5, 3e-5)
TILE = 16


def main() -> None:
    from joxsz_torch.build import build_session
    from joxsz_torch.ops import mass_veto
    from joxsz_torch.ops import step_kernel as sk
    from joxsz_torch.ops.joint_kernel import (joint_ll, joint_ll_plain,
                                              pack_consts)
    from joxsz_torch.synth import TRUTH, write_synthetic_dataset

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    args = ap.parse_args()
    cfg = write_synthetic_dataset(tempfile.mkdtemp(), 11)
    sess = build_session(cfg, device="cpu")
    c, m = pack_consts(sess), sess.model
    th0 = np.array([TRUTH[k] for k in sess.params.thawed])
    K, W, D = 4, 1024, th0.size
    betas = np.array([1.0, 0.6, 0.36, 0.216])
    beta = torch.tensor(betas, dtype=torch.float32)
    db = torch.tensor([float(np.float32(betas[k] - betas[k + 1]))
                       for k in range(K - 1)], dtype=torch.float32)
    rng = np.random.default_rng(8)
    x = torch.tensor(th0[None, None] * (1 + 0.01 * rng.standard_normal(
        (K, W, D))), dtype=torch.float32).contiguous()
    lp = joint_ll(x.reshape(K * W, D), c).reshape(K, W)
    acc = torch.zeros((K, W))
    sacc = torch.zeros(K - 1, dtype=torch.int32)
    r = m.sz_data.r_press_kpc
    # per half-step: the tiles (16 proposals) with a pair for tiers 2-3,
    # that pair count, the pairs the float64 tier decided
    halves = []

    def counted(th, cc):
        before = mass_veto.F64_PAIRS[0]
        det = {}
        out = joint_ll_plain(th, cc, det)
        cand = det["cand"]
        tiles = cand.any(dim=1).reshape(-1, TILE).any(dim=1)
        halves.append((int(tiles.sum()), int(cand.sum()),
                       mass_veto.F64_PAIRS[0] - before))
        return out

    sk.joint_ll_plain = counted
    n_steps = 0
    for it in range(args.steps // 20):
        halves.clear()
        sk.stretch_steps(x, lp, acc, sacc, beta, db, 99 + it, 20, c)
        n_steps += 20
        th = x.reshape(K * W, D).double()
        with torch.no_grad():
            keep = torch.isfinite(m.log_like_batch(th)).numpy()
            M = m.mass(m.params.unpack(th), r).numpy()
        n = M.shape[1]
        lo = np.r_[0, np.arange(n - 2), n - 2]
        hi = np.r_[1, np.arange(2, n), n - 1]
        rel = np.abs(M[:, hi] - M[:, lo]) / np.maximum(np.abs(M[:, hi]),
                                                       np.abs(M[:, lo]))
        close = {e: (keep & (rel < e).any(axis=1)).reshape(K, W)
                 .sum(axis=1).tolist() for e in EPS}
        before = mass_veto.F64_PAIRS[0]
        det = {}
        joint_ll_plain(x.reshape(K * W, D), c, det)
        t1 = det["cand"].any(dim=1).reshape(K, W).sum(dim=1).tolist()
        h = np.array(halves)
        print(f"after {n_steps} steps: walkers per rung (beta "
              f"{betas.tolist()}) with a pair within eps: {close}; "
              f"tier 1 unsure: {t1} walkers, float64 tier: "
              f"{mass_veto.F64_PAIRS[0] - before} pairs | over the last 20 "
              f"steps' {len(h)} half-steps of {K * W // 2} proposals: "
              f"{int((h[:, 0] > 0).sum())} with tiers 2-3 (tiles per "
              f"half-step: mean {h[:, 0].mean():.2f}, max {h[:, 0].max()}; "
              f"pairs {h[:, 1].sum()}), {int((h[:, 2] > 0).sum())} with the "
              f"float64 tier ({h[:, 2].sum()} pairs)", flush=True)


if __name__ == "__main__":
    main()
