"""Kernels 1-4 of two source trees of the port, compared bitwise on a card.

A change to the shared device code (``joxsz_torch/csrc/joint_ll.cuh``) or
to the constants' layout must not move the bits of the kernels that were
already there.  Each tree (this checkout, and another checkout of the
repository given as ``PARENT_DIR``: it needs ``joxsz_torch/`` and
``data/tables/cl1226_ctrate.npz``) runs in its own process, builds its
own kernels, makes the synthetic CL J1226 dataset from seed 11, evaluates
kernel 1 on 4096 parameter rows, runs 50 tempered steps (kernels 2 and 3)
at W=1024, K=4 from one start state and Philox seed, and 20 cluster-grid
steps (kernel 4) at C=4, W=1024 on four simulated clusters.  The outputs
must be equal bit for bit; exit code 1 if any differs.  Each process also
times the half-step launch at K=1 and K=4 (CUDA events over 200 launches);
the trees run in the order change, parent, parent, change, so the two
sources' times stand beside each other from one card and one call.

    git archive <parent> joxsz_torch data/tables | tar -x -C build/parent
    python3 scripts/torch_kernel_bits_vs_parent.py build/parent
"""
import os
import subprocess
import sys

import numpy as np

CHILD = r'''
import sys, numpy as np, torch
tree, out = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
from joxsz_torch.build import build_session
from joxsz_torch.synth import write_synthetic_dataset, TRUTH
from joxsz_torch.ops.joint_kernel import pack_consts, joint_ll
from joxsz_torch.ops.step_kernel import stretch_half, swap
cfg = write_synthetic_dataset(out + "_data", 11)
sess = build_session(cfg, device="cuda")
c = pack_consts(sess)
th0 = np.array([TRUTH[k] for k in sess.params.thawed])
rng = np.random.default_rng(5)
rows = torch.tensor(th0[None] * (1 + 0.03 * rng.standard_normal((4096, 13))), dtype=torch.float32, device="cuda")
ll = joint_ll(rows, c)
K, W = 4, 1024
x = torch.tensor(th0[None, None] * (1 + 0.01 * rng.standard_normal((K, W, 13))), dtype=torch.float32, device="cuda").contiguous()
lp = joint_ll(x.reshape(K * W, 13), c).reshape(K, W)
acc = torch.zeros((K, W), dtype=torch.float32, device="cuda")
beta = torch.tensor([1.0, 0.6, 0.36, 0.216], dtype=torch.float32, device="cuda")
sacc = torch.zeros(3, dtype=torch.int32, device="cuda")
for i in range(50):
    stretch_half(x, lp, acc, beta, 0, 1234, i, c)
    stretch_half(x, lp, acc, beta, 1, 1234, i, c)
    for kk in range(3):
        swap(x, lp, sacc, kk, 1234, i, float(np.float32(beta[kk].item() - beta[kk + 1].item())))
from joxsz_torch.ops.joint_kernel import pack_consts_stack
from joxsz_torch.ops.multicluster_kernel import multicluster_ll, stretch_half_multicluster
from joxsz_torch.simulate import simulate_survey
C = 4
truths = np.tile(th0, (C, 1))
truths[:, sess.params.thawed.index("P_0")] *= np.linspace(0.7, 1.3, C)
survey = simulate_survey(sess.model, truths, np.random.default_rng(13))
stack = pack_consts_stack(sess, survey.sz_stack, survey.xray_stack)
xc = torch.tensor(truths[:, None] * (1 + 0.01 * rng.standard_normal((C, W, 13))), dtype=torch.float32, device="cuda").contiguous()
lpc = multicluster_ll(xc, stack)
accc = torch.zeros((C, W), dtype=torch.float32, device="cuda")
for i in range(20):
    stretch_half_multicluster(xc, lpc, accc, 0, 4321, i, stack)
    stretch_half_multicluster(xc, lpc, accc, 1, 4321, i, stack)
def ms(fn, reps=200):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
x1, lp1, acc1, beta1 = x[:1].clone(), lp[:1].clone(), acc[:1].clone(), beta[:1].clone()
xt, lpt, acct = x.clone(), lp.clone(), acc.clone()
xg, lpg, accg = xc.clone(), lpc.clone(), accc.clone()
print(tree, "half-step ms: K=1 %.4f, K=4 %.4f, cluster grid C=4 %.4f" % (
    ms(lambda: stretch_half(x1, lp1, acc1, beta1, 0, 1234, 0, c)),
    ms(lambda: stretch_half(xt, lpt, acct, beta, 0, 1234, 0, c)),
    ms(lambda: stretch_half_multicluster(xg, lpg, accg, 0, 4321, 0, stack))), flush=True)
torch.cuda.synchronize()
np.savez(out, ll=ll.cpu().numpy(), x=x.cpu().numpy(), lp=lp.cpu().numpy(), acc=acc.cpu().numpy(), sacc=sacc.cpu().numpy(), xc=xc.cpu().numpy(), lpc=lpc.cpu().numpy(), accc=accc.cpu().numpy())
'''
if len(sys.argv) != 2:
    sys.exit(__doc__)
os.makedirs("build", exist_ok=True)
outs = []
for name, tree in (("change", "."), ("parent", sys.argv[1]),
                   ("parent", sys.argv[1]), ("change", ".")):
    out = f"build/bits_{name}"
    subprocess.run([sys.executable, "-c", CHILD, tree, out], check=True)
    outs.append(np.load(out + ".npz"))
ok = True
for k in outs[0].files:
    same = np.array_equal(outs[0][k], outs[1][k], equal_nan=True) if outs[0][k].dtype.kind == "f" else np.array_equal(outs[0][k], outs[1][k])
    print(k, outs[0][k].shape, "bitwise equal" if same else "DIFFER", float(np.nanmax(np.abs(outs[0][k].astype(float) - outs[1][k].astype(float)))) if not same else 0.0)
    ok &= same
print("finite ll rows", int(np.isfinite(outs[0]["ll"]).sum()), "accepted swaps", outs[0]["sacc"].tolist(), "mean acc", float(outs[0]["acc"].mean()), "mean cluster-grid acc", float(outs[0]["accc"].mean()))
sys.exit(0 if ok else 1)
