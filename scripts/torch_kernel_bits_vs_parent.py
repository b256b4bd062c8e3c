"""The kernels of two source trees of the port, compared and timed on a card.

Each tree (this checkout, and another checkout of the repository given as
``PARENT_DIR``: it needs ``joxsz_torch/`` and ``data/tables/
cl1226_ctrate.npz``) runs in its own process, builds its own kernels and
makes the synthetic CL J1226 dataset from seed 11.  A tree whose step
kernel runs a chunk of steps per launch (``ops.step_kernel.
stretch_steps``) is driven through it; an older tree through its
per-half-step and per-boundary launches (``stretch_half`` / ``swap`` /
``stretch_half_multicluster``).  Each process records:

* kernel 1 on 4096 parameter rows (3% around the truth), and on the
  same share around the truth of the double density and of knot
  pressure, which take the family instance;
* one tempered step (W=1024, K=4, Philox seed 1234) from each of 20 start
  states, with the kernel's decisions and the margins of the same step run
  in plain torch on that tree's kernel-1 likelihood, and which of its
  proposals kernel 1 vetoes;
* times on the card: kernel 1 (CUDA events; the flagship, and the family
  instance on the double density and on knots); device time per half-step at
  2048 rows (the cluster grid, C=4), 512 rows (K=1, W=1024) and 16 rows
  (K=1, W=32) and per tempered step at K=4, W=1024 (torch.profiler, over
  100 steps); the survey fit (``fit_survey``, C=4, W=1024, 1000 + 1000
  steps) ``sampling_s``; the hybrid mesh sampler (W=128 over four shards
  on this card, 40 windows of 101 steps) in evals/s; where the tree has
  the mass veto's float64 tier, the pairs it decided over 100 K=4 steps
  from the timed state.

The two trees' outputs must agree as ``chip_smoke.py`` phases 3-4 hold a
kernel to its plain version: kernel 1 (each of the three families) with
identical -inf masks, apart from rows where this checkout's verdict is
the float64 model's, and finite values within rtol=2e-4, atol=0.5; a
step decision may differ where the two trees' kernel 1 disagree on the
proposal's veto (counted and printed) or where the decision lies within
MARGIN (1e-3) plus the two trees' threshold difference of its threshold
(a change of summation order moves a log-posterior by float32 rounding,
and so a threshold, and nothing else), and that difference stays within
2 beta x 0.05 + MARGIN.  Exit code 1 if they do not.  The trees run in the order change, parent,
parent, change, so their times stand beside each other from one card and
one call.

    git archive <parent> joxsz_torch data/tables | tar -x -C build/parent
    python3 scripts/torch_kernel_bits_vs_parent.py build/parent
"""
import os
import subprocess
import sys

import numpy as np

CHILD = r'''
import copy, sys, time, numpy as np, torch
tree, out = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
from torch.profiler import ProfilerActivity, profile
from joxsz_torch.build import build_session
from joxsz_torch.synth import write_synthetic_dataset, truth_theta, TRUTH
from joxsz_torch.ops import step_kernel as sk, multicluster_kernel as mk
from joxsz_torch.ops.joint_kernel import pack_consts, pack_consts_stack, joint_ll
from joxsz_torch.models.multicluster import stack_sz_data, stack_xray_data
from joxsz_torch.parallel import make_mesh
from joxsz_torch.parallel.kernel_sharded import run_hybrid_coupled_ensemble
from joxsz_torch.simulate import simulate_survey
from joxsz_torch import survey
fused = hasattr(sk, "stretch_steps")
cfg = write_synthetic_dataset(out + "_data", 11)
sess = build_session(cfg, device="cuda")
c = pack_consts(sess)
D = 13
th0 = np.array([TRUTH[k] for k in sess.params.thawed])
rng = np.random.default_rng(5)
rows = torch.tensor(th0[None] * (1 + 0.03 * rng.standard_normal((4096, D))), dtype=torch.float32, device="cuda")
ll = joint_ll(rows, c)
with torch.no_grad():
    f64 = {"ll": torch.isfinite(sess.model.log_like_batch(rows.double())).cpu().numpy()}
K, W, H = 4, 1024, 512
betas = np.array([1.0, 0.6, 0.36, 0.216])
beta = torch.tensor(betas, dtype=torch.float32, device="cuda")
dbl = [float(np.float32(betas[k] - betas[k + 1])) for k in range(K - 1)]
db = torch.tensor(dbl, dtype=torch.float32, device="cuda")

def state(k, w, seed):
    r = np.random.default_rng(seed)
    x = torch.tensor(th0[None, None] * (1 + 0.01 * r.standard_normal((k, w, D))), dtype=torch.float32, device="cuda").contiguous()
    return x, joint_ll(x.reshape(k * w, D), c).reshape(k, w), torch.zeros((k, w), dtype=torch.float32, device="cuda")

def steps(x, lp, acc, b, seed, n, step0=0):
    """n steps of the rung step (the K-1 sweep included) from step0."""
    k = x.shape[0]
    sacc = torch.zeros(max(k - 1, 1), dtype=torch.int32, device="cuda")
    if fused:
        sk.stretch_steps(x, lp, acc, sacc, b, db[:k - 1], seed, n, c, step0=step0)
    else:
        for i in range(step0, step0 + n):
            sk.stretch_half(x, lp, acc, b, 0, seed, i, c)
            sk.stretch_half(x, lp, acc, b, 1, seed, i, c)
            for kk in range(k - 1):
                sk.swap(x, lp, sacc, kk, seed, i, dbl[kk])
    return sacc

bits = sk.philox_stream(1234, "cuda")
fin = []

def lp_k1(th):
    out = joint_ll(th, c)
    fin.append(torch.isfinite(out).reshape(K, H).cpu().numpy())
    return out

dec, m0, m1, msw, nsw, fin0, fin1 = [], [], [], [], [], [], []
for s in range(20):
    x, lp, acc = state(K, W, 100 + s)
    xr, lr, ar = x, lp, acc
    ms = []
    for which in (0, 1):
        xr, lr, ar, _, m = sk.half_step_plain(xr, lr, ar, beta, which, bits(s, which, K * H, 4), lp_k1)
        ms.append(m)
    sw = []
    for kk in range(K - 1):
        u = torch.stack([bits(s, 16 + 2 * kk + hb, H, 1)[:, 0] for hb in (0, 1)])
        xr, lr, _, m = sk.swap_plain(xr, lr, kk, 1234, s, u, dbl[kk])
        sw.append(m)
    sacc = steps(x, lp, acc, beta, 1234, 1, step0=s)
    dec.append((acc > 0.5).cpu().numpy()); m0.append(ms[0].cpu().numpy()); m1.append(ms[1].cpu().numpy())
    fin0.append(fin[-2]); fin1.append(fin[-1])
    msw.append(torch.stack(sw).cpu().numpy()); nsw.append(sacc[:K - 1].cpu().numpy())

def ev_ms(fn, reps):
    fn(); torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record(); torch.cuda.synchronize()
    return a.elapsed_time(b) / reps

def device_us(fn):
    """(device us of the step kernels, wall us) over one call of fn."""
    fn(); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter(); fn(); torch.cuda.synchronize(); wall = 1e6 * (time.perf_counter() - t0)
    us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        name = e.key.split("(")[0]
        if name in ("stretch_half_kernel", "swap_kernel", "stretch_steps_kernel"):
            us += t
    return us, wall

n = 100
t = {"k1_ms": ev_ms(lambda: joint_ll(rows, c), 50)}
fam_ll = {}
for tag, field, value in (("double", "density_mode", "double"), ("knots", "pressure_model", "knots")):
    fcfg = copy.deepcopy(cfg)
    setattr(fcfg, field, value)
    fs = build_session(fcfg, device="cuda")
    fc = pack_consts(fs)
    tf = truth_theta(fs)
    frows = torch.tensor(tf[None] * (1 + 0.03 * np.random.default_rng(5).standard_normal((4096, tf.size))), dtype=torch.float32, device="cuda")
    fam_ll[tag] = joint_ll(frows, fc).cpu().numpy()
    with torch.no_grad():
        f64["ll_" + tag] = torch.isfinite(fs.model.log_like_batch(frows.double())).cpu().numpy()
    t[f"k1_ms {tag}"] = ev_ms(lambda: joint_ll(frows, fc), 50)
for label, k, w in (("512 rows", 1, 1024), ("16 rows", 1, 32)):
    x, lp, acc = state(k, w, 7)
    us, _ = device_us(lambda: steps(x, lp, acc, beta[:1], 99, n))
    t["half_us " + label] = us / (2 * n)
x, lp, acc = state(K, W, 8)
us, wall = device_us(lambda: steps(x, lp, acc, beta, 99, n))
t["K=4 step device us"], t["K=4 step wall us"] = us / n, wall / n
t["K=4 step events us"] = 1e3 * ev_ms(lambda: steps(x, lp, acc, beta, 99, n), 3) / n
if hasattr(sk, "f64_pairs"):
    x, lp, acc = state(K, W, 8)
    sk.f64_pairs(reset=True)
    steps(x, lp, acc, beta, 99, n)
    t["K=4 float64-tier pairs per 100 steps"] = sk.f64_pairs(reset=True) * 100.0 / n
m = sess.model
copies = pack_consts_stack(sess, stack_sz_data([m.sz_data] * 4), stack_xray_data([m.xray_data] * 4))
x, lp, acc = state(4, W, 9)
if fused:
    fn = lambda: mk.stretch_steps_multicluster(x, lp, acc, 99, n, copies)
else:
    def fn():
        for i in range(n):
            for which in (0, 1):
                mk.stretch_half_multicluster(x, lp, acc, which, 99, i, copies)
prof_us = 0.0
fn(); torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    fn(); torch.cuda.synchronize()
for e in prof.key_averages():
    if e.key.split("(")[0] in ("stretch_half_kernel", "stretch_steps_kernel"):
        prof_us += getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
t["half_us 2048 rows"] = prof_us / (2 * n)
C = 4
truths = np.tile(th0, (C, 1)); truths[:, sess.params.thawed.index("P_0")] *= np.linspace(0.7, 1.3, C)
sv = simulate_survey(sess.model, truths, np.random.default_rng(13))
res = survey.fit_survey(sess, sv.sz_stack, sv.xray_stack, truths, n_walkers=1024, n_burn=1000, n_steps=1000, thin=5, seed=3)
t["survey sampling_s"] = res.timings["sampling_s"]
mesh = make_mesh(4, axis_names=("walker",), devices=[torch.device("cuda", 0)] * 4)
p0 = torch.tensor(th0[None] * (1 + 0.01 * np.random.default_rng(4).standard_normal((128, D))), dtype=torch.float32, device="cuda")
run_hybrid_coupled_ensemble(c, p0, 2, 101, 5, mesh, thin=5, allow_small=True)
torch.cuda.synchronize(); t0 = time.perf_counter()
run_hybrid_coupled_ensemble(c, p0, 40, 101, 5, mesh, thin=5, allow_small=True)
torch.cuda.synchronize()
t["hybrid evals/s"] = 128 * 40 * 101 / (time.perf_counter() - t0)
print(tree, "fused" if fused else "per-launch", {k: round(v, 4) for k, v in t.items()}, flush=True)
np.savez(out, ll=ll.cpu().numpy(), ll_double=fam_ll["double"], ll_knots=fam_ll["knots"], **{"f64_" + k: v for k, v in f64.items()}, dec=np.stack(dec), m0=np.stack(m0), m1=np.stack(m1), msw=np.stack(msw), nsw=np.stack(nsw), fin0=np.stack(fin0), fin1=np.stack(fin1))
'''
MARGIN, RTOL, ATOL, TIGHT = 1e-3, 2e-4, 0.5, 0.05
BETAS = np.array([1.0, 0.6, 0.36, 0.216])


def compare(a, b) -> bool:
    """The rule of chip_smoke.py phases 3-4 between two trees."""
    ok = True
    for key in ("ll", "ll_double", "ll_knots"):
        if key not in a.files or key not in b.files:
            continue
        fa, fb = np.isfinite(a[key]), np.isfinite(b[key])
        # a -inf mask may differ only where the first tree's verdict is
        # the float64 model's (a veto decided in float64 by one tree)
        f = a["f64_" + key] if "f64_" + key in a.files else fa
        moved = np.flatnonzero(fa != fb)
        same_mask = bool(np.all(fa[moved] == f[moved]))
        both = fa & fb
        close = same_mask and np.allclose(a[key][both], b[key][both],
                                          rtol=RTOL, atol=ATOL)
        err = float(np.max(np.abs(a[key][both] - b[key][both])))
        print(f"kernel 1 ({key}): -inf masks differ on rows "
              f"{moved.tolist()}, each with the float64 verdict on the "
              f"first tree's side: {same_mask}; rows finite in both within "
              f"rtol/atol: {close}, max |diff| {err:.4g}")
        ok &= bool(close)
    H = a["m0"].shape[-1]
    n_dec = n_flip = n_bad = n_veto = 0
    has_fin = "fin0" in a.files and "fin0" in b.files
    shift_max = 0.0
    for s in range(a["dec"].shape[0]):
        flipped = False
        for which, key in ((0, "m0"), (1, "m1")):
            da = a["dec"][s][:, which * H:(which + 1) * H]
            dbb = b["dec"][s][:, which * H:(which + 1) * H]
            ma, mb = a[key][s], b[key][s]
            both = np.isfinite(ma) & np.isfinite(mb)
            shift = np.where(both, np.abs(ma - mb), 0.0)
            shift_max = max(shift_max, float(shift.max()))
            ok &= bool(np.all(shift <= 2 * TIGHT * BETAS[:, None] + MARGIN))
            diff = da != dbb
            # a proposal whose veto verdict the two trees' kernel 1 give
            # differently
            veto = (a[f"fin{which}"][s] != b[f"fin{which}"][s]) if has_fin \
                else np.zeros_like(diff)
            n_dec += da.size
            n_flip += int(diff.sum())
            n_veto += int((diff & veto).sum())
            n_bad += int((diff & ~veto & ~(np.abs(ma) < MARGIN + shift))
                         .sum())
            if diff.any():
                flipped = True
                break
        if not flipped:
            diff = a["nsw"][s] != b["nsw"][s]
            near = (np.abs(a["msw"][s]) < MARGIN + np.abs(
                a["msw"][s] - b["msw"][s])).reshape(len(diff), -1).any(1)
            n_bad += int((diff & ~near).sum())
    print(f"steps: {n_dec} half-step decisions over 20 states, {n_flip} "
          f"differ between the trees, {n_veto} of them at a proposal whose "
          f"veto verdict differs between the trees' kernel 1, "
          f"{n_flip - n_veto} others; {n_bad} farther than MARGIN + the "
          f"trees' threshold difference from the threshold; largest "
          f"threshold difference {shift_max:.4g}")
    return ok and n_bad == 0


if len(sys.argv) != 2:
    sys.exit(__doc__)
os.makedirs("build", exist_ok=True)
outs = []
for name, tree in (("change", "."), ("parent", sys.argv[1]),
                   ("parent", sys.argv[1]), ("change", ".")):
    out = f"build/bits_{name}"
    subprocess.run([sys.executable, "-c", CHILD, tree, out], check=True)
    outs.append(np.load(out + ".npz"))
sys.exit(0 if compare(outs[0], outs[1]) else 1)
