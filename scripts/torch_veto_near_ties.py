"""How often the posterior sits on the mass veto's float32 resolution.

Runs the step kernel's plain version (``ops.step_kernel.stretch_steps`` on
CPU tensors) at K=4, W=1024 on the synthetic CL J1226 dataset (seed 11)
from a 1% cloud around the truth, and after every 20 steps counts, per
rung, the walkers the float64 model keeps whose mass veto holds a pair of
masses (np.gradient's pairs on the pressure grid) closer than a relative
difference ``eps`` of the larger mass: pairs a float32 comparison
cannot be sure of.  A float64 tie-break in the step kernel runs for each
such walker, so these counts say how often a half-step of 2048 walkers
meets one.

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


def main() -> None:
    from joxsz_torch.build import build_session
    from joxsz_torch.ops import step_kernel as sk
    from joxsz_torch.ops.joint_kernel import joint_ll, pack_consts
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
    for it in range(args.steps // 20):
        sk.stretch_steps(x, lp, acc, sacc, beta, db, 99 + it, 20, c)
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
        print(f"after {20 * (it + 1)} steps: walkers per rung (beta "
              f"{betas.tolist()}) with a pair within eps: {close}",
              flush=True)


if __name__ == "__main__":
    main()
