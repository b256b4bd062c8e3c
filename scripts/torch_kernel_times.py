"""Kernel 1 and the step kernel of several source trees, timed on a card.

Each tree (a checkout of the repository, or a copy with a change to
compare: it needs ``joxsz_torch/`` and ``data/tables/cl1226_ctrate.npz``)
runs in its own process, in the order A B .. B A, builds its own kernels
and times, with CUDA events, on the synthetic CL J1226 dataset (seed
11): kernel 1 on 4096 rows 3% around the truth (200 launches), 100 steps
of the step kernel at K=1, W=32 (per half-step of 16 rows), at K=1,
W=1024 and at K=4, W=1024 (per step), each from a 1% cloud.  Each tree
then prints a digest of kernel 1's output on those rows and of the
state after 20 K=4 steps from a fresh cloud: trees whose digests agree
computed them bit for bit alike.  Lighter than
``torch_kernel_bits_vs_parent.py``, which compares the trees' outputs
in detail.

    python3 scripts/torch_kernel_times.py . build/parent build/variant
"""
import subprocess
import sys

CHILD = r'''
import sys, tempfile, numpy as np, torch
tree = sys.argv[1]
sys.path.insert(0, tree)
from joxsz_torch.build import build_session
from joxsz_torch.synth import write_synthetic_dataset, TRUTH
from joxsz_torch.ops import step_kernel as sk
from joxsz_torch.ops.joint_kernel import pack_consts, joint_ll
cfg = write_synthetic_dataset(tempfile.mkdtemp(), 11)
sess = build_session(cfg, device="cuda"); c = pack_consts(sess)
D = 13
th0 = np.array([TRUTH[k] for k in sess.params.thawed])
rows = torch.tensor(th0[None] * (1 + 0.03 * np.random.default_rng(5).standard_normal((4096, D))), dtype=torch.float32, device="cuda")
betas = np.array([1.0, 0.6, 0.36, 0.216])
beta = torch.tensor(betas, dtype=torch.float32, device="cuda")
db = torch.tensor([float(np.float32(betas[k] - betas[k + 1])) for k in range(3)], dtype=torch.float32, device="cuda")
def state(k, w, seed):
    r = np.random.default_rng(seed)
    x = torch.tensor(th0[None, None] * (1 + 0.01 * r.standard_normal((k, w, D))), dtype=torch.float32, device="cuda").contiguous()
    return x, joint_ll(x.reshape(k * w, D), c).reshape(k, w), torch.zeros((k, w), dtype=torch.float32, device="cuda")
def ev_ms(fn, reps):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps): fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps
def steps(x, lp, acc, b, n):
    k = x.shape[0]
    sacc = torch.zeros(max(k - 1, 1), dtype=torch.int32, device="cuda")
    sk.stretch_steps(x, lp, acc, sacc, b, db[:k - 1], 99, n, c)
t = {"k1_ms": ev_ms(lambda: joint_ll(rows, c), 200)}
x, lp, acc = state(1, 32, 7)
t["half_us 16 rows"] = 1e3 * ev_ms(lambda: steps(x, lp, acc, beta[:1], 100), 3) / 200
x, lp, acc = state(1, 1024, 10)
t["K=1 step us"] = 1e3 * ev_ms(lambda: steps(x, lp, acc, beta[:1], 100), 5) / 100
x, lp, acc = state(4, 1024, 8)
t["K=4 step us"] = 1e3 * ev_ms(lambda: steps(x, lp, acc, beta, 100), 5) / 100
import hashlib
x, lp, acc = state(4, 1024, 9)
steps(x, lp, acc, beta, 20)
h = hashlib.sha256()
for v in (joint_ll(rows, c), x, lp, acc):
    h.update(v.cpu().numpy().tobytes())
t["digest"] = h.hexdigest()[:16]
print(tree, {k: round(v, 4) if isinstance(v, float) else v
             for k, v in t.items()}, flush=True)
'''

trees = sys.argv[1:]
for tree in trees + trees[::-1]:
    subprocess.run([sys.executable, "-c", CHILD, tree], check=True)
