"""Mesh sampling of the port on N real cards (default 4) of one host.

``chip_smoke.py`` runs on one card and puts its four shards on it.  This
script needs N cards and holds the same runners on a mesh of N distinct
cards against the mesh of N shards on ``cuda:0``:

  1. kernel 6 over N shards on N cards equals the step kernel at K = 1
     on one card after every step, bit for bit
     (``chip_smoke.compare_coupled``), at W = 128 and W = 1024;
  2. every runner of ``joxsz_torch.parallel.kernel_sharded`` (hybrid,
     coupled, independent plain and tempered ensembles, cluster blocks)
     gives bit-identical chains on the two meshes, and its wall time on
     each (one card, cards, cards, one card), so the overlap of shards on
     different cards shows;
  3. the entry points ``survey --mock N --mesh N`` and ``run --mesh N``
     (W = 128, untempered, --quick: one MLE) complete.

Synthetic CL J1226 from seed 11, full width.  Exit code 1 if a check
fails.  Prints every card's name and power limit.

    python3 scripts/torch_mesh_four_cards.py [N]
"""
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from joxsz_torch import run, survey  # noqa: E402
from joxsz_torch.ops.joint_kernel import (joint_ll,  # noqa: E402
                                          pack_consts_stack)
from joxsz_torch.ops.multicluster_kernel import multicluster_ll  # noqa: E402
from joxsz_torch.parallel import (make_mesh,  # noqa: E402
                                  make_sharded_multicluster_step,
                                  run_coupled_sharded_ensemble,
                                  run_hybrid_coupled_ensemble,
                                  run_sharded_kernel_ensembles,
                                  run_sharded_tempered_ensembles)
from joxsz_torch.sampling.tempered import default_betas  # noqa: E402
from joxsz_torch.simulate import simulate_survey  # noqa: E402
from joxsz_torch.synth import TRUTH, config_json  # noqa: E402

N = int(sys.argv[1]) if len(sys.argv) > 1 else 4
SEED = 11


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return out, time.time() - t0


def same(a, b) -> bool:
    return (np.array_equal(a.chain, b.chain)
            and np.array_equal(a.log_prob, b.log_prob)
            and np.array_equal(a.acceptance_fraction, b.acceptance_fraction))


def main() -> int:
    if torch.cuda.device_count() < N:
        print(f"needs {N} cards, sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    tmp = tempfile.mkdtemp(prefix="joxsz_mesh_")
    cs.phase_build()
    cfg, sess, c = cs.phase_session(tmp, SEED)
    cards = [torch.device("cuda", i) for i in range(N)]
    meshes = {"one card": make_mesh(N, devices=[cards[0]] * N),
              "cards": make_mesh(N, devices=cards)}
    th0 = np.array([TRUTH[k] for k in sess.params.thawed])
    rng = np.random.default_rng(SEED)
    starts = {}
    for W in (128, 1024):
        x0 = torch.tensor(th0[None] * (1 + 0.01 * rng.standard_normal(
            (W, 13))), dtype=torch.float32, device="cuda").contiguous()
        starts[W] = x0
        cs.compare_coupled(x0, joint_ll(x0, c), c, 4242, N, devices=cards)
        print(f"[1] W={W}: kernel 6 over {N} shards on {N} cards == the "
              "step kernel at K=1 on one card, bit for bit")

    betas = default_betas(4)
    runners = {
        "hybrid W=128, 10 windows of 101 steps, thin 5": (
            128 * 1010, lambda m: run_hybrid_coupled_ensemble(
                c, starts[128], 10, 101, 7, m, thin=5, allow_small=True)),
        "coupled W=128, 200 steps": (
            128 * 200, lambda m: run_coupled_sharded_ensemble(
                c, starts[128], 200, 7, m, thin=5)),
        "independent W=1024, 500 steps": (
            1024 * 500, lambda m: run_sharded_kernel_ensembles(
                c, starts[1024], 500, np.random.default_rng(3), m, thin=5)),
        "tempered K=4 W=1024, 200 steps": (
            4 * 1024 * 200, lambda m: run_sharded_tempered_ensembles(
                c, starts[1024], betas, 200, np.random.default_rng(3), m,
                thin=5)),
    }
    ok = True
    for name, (evals, fn) in runners.items():
        fn(meshes["cards"])                       # warm both meshes
        res, walls = {}, {"one card": [], "cards": []}
        for key in ("one card", "cards", "cards", "one card"):
            res[key], dt = timed(lambda: fn(meshes[key]))
            walls[key].append(dt)
        eq = same(res["one card"], res["cards"])
        ok &= eq
        print(f"[2] {name}: one card {min(walls['one card']):.3f} s "
              f"({evals / min(walls['one card']):.0f} evals/s), {N} cards "
              f"{min(walls['cards']):.3f} s ({evals / min(walls['cards']):.0f}"
              f" evals/s); all walls {walls}; chains "
              + ("bit-identical" if eq else "DIFFER"))

    # cluster blocks
    truths = np.tile(th0, (N, 1))
    truths[:, sess.params.thawed.index("P_0")] *= np.linspace(0.7, 1.3, N)
    sv = simulate_survey(sess.model, truths, np.random.default_rng(13))
    stack = pack_consts_stack(sess, sv.sz_stack, sv.xray_stack)
    xc = torch.tensor(truths[:, None] * (1 + 0.01 * rng.standard_normal(
        (N, 1024, 13))), dtype=torch.float32, device="cuda").contiguous()
    lpc = multicluster_ll(xc, stack)
    outs = {}
    for key in ("one card", "cards", "cards", "one card"):
        mesh = make_mesh(N, axis_names=("cluster",),
                         devices=meshes[key].devices)
        fn = make_sharded_multicluster_step(stack, mesh, 500, thin=5)
        outs[key], dt = timed(lambda: fn(xc, lpc, torch.zeros_like(lpc),
                                         list(range(N))))
        print(f"[2] cluster blocks C={N}, W=1024, 500 steps on {key}: "
              f"{dt:.3f} s ({N * 1024 * 500 / dt:.0f} evals/s)")
    eq = all(torch.equal(a, b) for a, b in zip(outs["one card"],
                                               outs["cards"]))
    ok &= eq
    print("[2] cluster blocks: " + ("bit-identical" if eq else "DIFFER"))

    cfg.save_dir = tmp
    path = config_json(cfg, f"{tmp}/mesh.json")
    r, dt = timed(lambda: survey.main(
        ["--mock", str(N), "--config", path, "--walkers", "1024", "--mesh",
         str(N), "--seed", str(SEED), "--out", f"{tmp}/survey.json"]))
    acc = r.acceptance.mean(axis=1)
    good = bool(np.all(np.isfinite(r.log_prob)) and np.all(acc > 0.1))
    ok &= good
    print(f"[3] survey --mock {N} --mesh {N} in {dt:.1f} s: sampling_s "
          f"{r.timings['sampling_s']:.2f}, acceptance "
          f"{np.round(acc, 3).tolist()}")
    r, dt = timed(lambda: run.main(
        ["--config", path, "--quick", "--walkers", "128", "--temper", "0",
         "--mesh", str(N), "--seed", str(SEED)]))
    a = float(np.mean(r.acceptance_fraction))
    good = bool(np.all(np.isfinite(r.log_prob)) and 0.02 < a < 0.8)
    ok &= good
    print(f"[3] run --mesh {N} --quick in {dt:.1f} s (MLE "
          f"{r.timings['mle_s']:.1f} s, sampling {r.timings['sample_s']:.2f} "
          f"s): acceptance {a:.3f}, frame spacing "
          f"{r.timings['frame_spacing']}")
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
