"""Where a likelihood tile and a swap sweep spend their time on the card.

Builds ``joxsz_torch/csrc/joint_ll.cu`` and ``stretch_step.cu`` once more
with ``-DJT_PHASE_CLOCKS`` (thread 0 of block 0 records ``clock64()`` at
each phase boundary of ``joint_ll_tile`` and around the swap sweep, and
adds up block 0's cycles on the mass veto's tiers 2-3) into
``build/phase_probe/``, runs kernel 1 on the synthetic CL J1226 dataset
(seed 11) at 16 rows (one tile on an idle card) and at 4096 rows (block
0's last tile among a full grid), and one step of the step kernel at K=4,
W=1024 (then 20 more from the same state), and prints the SM cycles of
each phase, their share of the tile, the sweep's cycles, the veto tiers'
(the last warp's cycles on the listed pairs, beside the X-ray phases,
the pairs and tiles, the tiles whose list was full) and the card's SM
clock and power limit beside them.

``--tiles`` builds only the step kernel's probe and reads every block's
tiles (the SM cycles of each, the pairs it listed for the mass veto's
tiers 2-3 and the last warp's cycles on them) over 20 steps at K=4 and
at K=1, W=1024, after 100 steps from a 1% cloud around the truth: a
half-step's time is its slowest block's, so the lines say how far the
tiles holding pairs set it.

    python3 scripts/torch_tile_phases.py [--tiles]
"""
import ctypes
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("scalars and priors", "pressure grid (per radius)",
          "mass veto, T(0), integrated Y", "wait for staged constants",
          "pp @ L^T", "y->mJy lerp x calibration", "prof @ G^T",
          "chi^2 per walker", "X-ray taps per shell", "X-ray emissivities",
          "X-ray projection, Cash terms", "Cash sums", "combine")
ORDER = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13)
N_CLOCKS = 21                   # JT_N_CLOCKS of csrc/joint_ll.cuh


def veto_line(clk) -> str:
    """Block 0's totals of the mass veto's deferred pairs."""
    return (f"  mass veto tiers 2-3 (block 0, all its tiles): {clk[16]} "
            f"cycles of the last warp on {clk[17]} pairs in {clk[18]} "
            f"tiles (beside the X-ray phases), at most {clk[20]} in one; "
            f"{clk[19]} of the tiles with a full list")


JT_MAX_BLOCKS, JT_TILE_SLOTS = 256, 128     # of csrc/joint_ll.cuh


def read_tiles(slib):
    """Every block's tiles since the last read: (cycles, last warp's
    cycles on the listed pairs, pairs listed), each (blocks, slots), and
    the tiles each block ran."""
    S = JT_MAX_BLOCKS * JT_TILE_SLOTS
    cyc, side = (ctypes.c_longlong * S)(), (ctypes.c_longlong * S)()
    pairs, n = (ctypes.c_int * S)(), (ctypes.c_int * JT_MAX_BLOCKS)()
    if slib.read_tile_clocks(cyc, side, pairs, n):
        raise RuntimeError("could not read the tile clocks")
    shape = (JT_MAX_BLOCKS, JT_TILE_SLOTS)
    return (np.array(cyc).reshape(shape), np.array(side).reshape(shape),
            np.array(pairs).reshape(shape), np.array(n))


def tile_spread(slib, n_half: int, label: str, card: str) -> None:
    """Print how the tiles of n_half half-steps spread: every block runs
    the same number of tiles a half-step, its time there their sum, and
    the half-step waits for its slowest block."""
    cyc, side, pairs, n = read_tiles(slib)
    used = np.flatnonzero(n)
    m = int(n[used[0]]) // n_half
    if m < 1 or np.any(n[used] != m * n_half) or m * n_half > JT_TILE_SLOTS:
        print(f"{label}: blocks ran {sorted(set(n[used].tolist()))} tiles, "
              f"not {n_half} half-steps of the same count")
        return
    c = cyc[used, :m * n_half].reshape(len(used), n_half, m)
    p = pairs[used, :m * n_half].reshape(len(used), n_half, m)
    sd = side[used, :m * n_half].reshape(len(used), n_half, m)
    flat_c, flat_p = c.reshape(-1), p.reshape(-1)
    with_p = flat_p > 0
    blk = c.sum(axis=2)                       # (blocks, half-steps)
    blk_p = (p > 0).any(axis=2)
    slow = blk.argmax(axis=0)
    hs = np.arange(n_half)
    slowest = blk[slow, hs]
    # the slowest block among those with no pairs, per half-step
    no_p = np.where(blk_p, 0, blk).max(axis=0)
    print(f"{label}: {len(used)} blocks x {m} tile(s) a half-step, "
          f"{n_half} half-steps; {card}")
    print(f"  tiles: {flat_c.size}, {int(with_p.sum())} with listed pairs "
          f"({100 * with_p.mean():.1f}%), {int(flat_p.sum())} pairs")
    print(f"  SM cycles a tile: without pairs median "
          f"{np.median(flat_c[~with_p]):.0f}, p90 "
          f"{np.percentile(flat_c[~with_p], 90):.0f}, max "
          f"{flat_c[~with_p].max()}" + (
              f"; with pairs median {np.median(flat_c[with_p]):.0f}, max "
              f"{flat_c[with_p].max()}, the last warp's cycles on them "
              f"median {np.median(sd.reshape(-1)[with_p]):.0f}, max "
              f"{sd.reshape(-1)[with_p].max()}" if with_p.any() else ""))
    print(f"  a half-step's slowest block: mean {slowest.mean():.0f} "
          f"cycles (its median block {np.median(blk, axis=0).mean():.0f}); "
          f"the slowest block held pairs in "
          f"{int(blk_p[slow, hs].sum())} of {n_half} half-steps; the "
          f"slowest block without pairs mean {no_p.mean():.0f}, so the "
          f"blocks with pairs add {(slowest - no_p).mean():.0f} cycles a "
          f"half-step")


def main() -> int:
    import torch
    from joxsz_torch.build import build_session
    from joxsz_torch.ops import _build
    from joxsz_torch.ops.joint_kernel import pack_consts
    from joxsz_torch.synth import TRUTH, write_synthetic_dataset

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if "--tiles" in sys.argv[1:]:
        return tiles_main()
    out = ROOT / "build" / "phase_probe"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libjoint_ll_phases.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DJT_PHASE_CLOCKS",
           "-o", str(lib_path), str(_build.CSRC / "joint_ll.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.launch_joint_ll.argtypes = _build.SIGNATURES["joint_ll"][
        "launch_joint_ll"]
    lib.read_phase_clocks.argtypes = [ctypes.c_void_p]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    cfg = write_synthetic_dataset(str(ROOT / "build" / "phase_probe_data"),
                                  11)
    sess = build_session(cfg, device="cuda")
    c = pack_consts(sess)
    th0 = np.array([TRUTH[k] for k in sess.params.thawed])
    rng = np.random.default_rng(5)
    picked = ctypes.c_int(-1)        # the instance each launch reports
    for B in (16, 4096):
        rows = torch.tensor(th0[None] * (1 + 0.03 * rng.standard_normal(
            (B, th0.size))), dtype=torch.float32, device="cuda")
        res = torch.empty(B, dtype=torch.float32, device="cuda")
        for _ in range(3):
            err = lib.launch_joint_ll(
                rows.data_ptr(), B, res.data_ptr(), c.buf.data_ptr(),
                c.params.iv_ptr, c.params.fv_ptr,
                torch.cuda.current_stream().cuda_stream, ctypes.byref(picked))
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
        torch.cuda.synchronize()
        clk = (ctypes.c_longlong * N_CLOCKS)()
        if lib.read_phase_clocks(clk):
            raise RuntimeError("could not read the phase clocks")
        t = [clk[i] for i in ORDER]
        total = t[-1] - t[0]
        print(f"kernel 1 at {B} rows: a tile takes {total} SM cycles; "
              f"{card} (name, power limit, SM clock now)")
        for name, a, b in zip(PHASES, t[:-1], t[1:]):
            print(f"  {name:32s} {b - a:8d} cycles  "
                  f"{100 * (b - a) / total:5.1f}%")
        print(veto_line(clk))
    step_path = out / "libstretch_step_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DJT_PHASE_CLOCKS",
                    "-o", str(step_path),
                    str(_build.CSRC / "stretch_step.cu")],
                   check=True, capture_output=True, text=True)
    slib = ctypes.CDLL(str(step_path))
    slib.launch_stretch_steps.argtypes = _build.SIGNATURES["stretch_step"][
        "launch_stretch_steps"]
    slib.read_phase_clocks.argtypes = [ctypes.c_void_p]
    K, W = 4, 1024
    x = torch.tensor(th0[None, None] * (1 + 0.01 * rng.standard_normal(
        (K, W, th0.size))), dtype=torch.float32, device="cuda").contiguous()
    lp = torch.empty((K, W), dtype=torch.float32, device="cuda")
    lib.launch_joint_ll(x.data_ptr(), K * W, lp.data_ptr(),
                        c.buf.data_ptr(), c.params.iv_ptr, c.params.fv_ptr,
                        torch.cuda.current_stream().cuda_stream,
                        ctypes.byref(picked))
    acc = torch.zeros_like(lp)
    sacc = torch.zeros(K - 1, dtype=torch.int32, device="cuda")
    beta = torch.tensor([1.0, 0.6, 0.36, 0.216], device="cuda")
    db = beta[:-1] - beta[1:]
    for _ in range(3):
        bar = torch.zeros(1, dtype=torch.int32, device="cuda")
        err = slib.launch_stretch_steps(
            x.data_ptr(), lp.data_ptr(), acc.data_ptr(), sacc.data_ptr(),
            beta.data_ptr(), db.data_ptr(), K, W, 7, 0, 1, 0, None, None,
            0.70710677, 0.70710677, 0, 0, 0, bar.data_ptr(), c.buf.data_ptr(),
            c.params.iv_ptr, c.params.fv_ptr,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(picked))
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
    torch.cuda.synchronize()
    clk = (ctypes.c_longlong * N_CLOCKS)()
    if slib.read_phase_clocks(clk):
        raise RuntimeError("could not read the phase clocks")
    print(f"step kernel at K={K}, W={W}: block 0's tile {clk[13] - clk[0]} "
          f"SM cycles, the swap sweep (3 boundaries) {clk[15] - clk[14]} "
          f"SM cycles; {card}")
    t = [clk[i] for i in ORDER]
    for name, a, b in zip(PHASES, t[:-1], t[1:]):
        print(f"  {name:32s} {b - a:8d} cycles  "
              f"{100 * (b - a) / (t[-1] - t[0]):5.1f}%")
    print(veto_line(clk))
    bar = torch.zeros(1, dtype=torch.int32, device="cuda")
    err = slib.launch_stretch_steps(
        x.data_ptr(), lp.data_ptr(), acc.data_ptr(), sacc.data_ptr(),
        beta.data_ptr(), db.data_ptr(), K, W, 8, 0, 20, 0, None, None,
        0.70710677, 0.70710677, 0, 0, 0, bar.data_ptr(), c.buf.data_ptr(),
        c.params.iv_ptr, c.params.fv_ptr,
        torch.cuda.current_stream().cuda_stream, ctypes.byref(picked))
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    torch.cuda.synchronize()
    if slib.read_phase_clocks(clk):
        raise RuntimeError("could not read the phase clocks")
    print(f"after 20 more steps at K={K}, W={W} (the sums since the build):")
    print(veto_line(clk))
    return 0


def tiles_main() -> int:
    """--tiles: every block's tiles of the step kernel at K=4 and K=1."""
    import torch
    from joxsz_torch.build import build_session
    from joxsz_torch.ops import _build
    from joxsz_torch.ops.joint_kernel import joint_ll, pack_consts
    from joxsz_torch.synth import TRUTH, write_synthetic_dataset

    out = ROOT / "build" / "phase_probe"
    out.mkdir(parents=True, exist_ok=True)
    step_path = out / "libstretch_step_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DJT_PHASE_CLOCKS",
                    "-o", str(step_path),
                    str(_build.CSRC / "stretch_step.cu")],
                   check=True, capture_output=True, text=True)
    slib = ctypes.CDLL(str(step_path))
    slib.launch_stretch_steps.argtypes = _build.SIGNATURES["stretch_step"][
        "launch_stretch_steps"]
    slib.read_tile_clocks.argtypes = [ctypes.c_void_p] * 4
    slib.read_phase_clocks.argtypes = [ctypes.c_void_p]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    cfg = write_synthetic_dataset(str(ROOT / "build" / "phase_probe_data"),
                                  11)
    sess = build_session(cfg, device="cuda")
    c = pack_consts(sess)
    th0 = np.array([TRUTH[k] for k in sess.params.thawed])
    rng = np.random.default_rng(5)
    picked = ctypes.c_int(-1)
    for K, seed in ((4, 21), (1, 22)):
        W = 1024
        x = torch.tensor(th0[None, None] * (1 + 0.01 * rng.standard_normal(
            (K, W, th0.size))), dtype=torch.float32,
            device="cuda").contiguous()
        lp = joint_ll(x.reshape(K * W, -1), c).reshape(K, W).contiguous()
        acc = torch.zeros_like(lp)
        sacc = torch.zeros(max(K - 1, 1), dtype=torch.int32, device="cuda")
        beta = torch.tensor([1.0, 0.6, 0.36, 0.216][:K], device="cuda")
        db = (beta[:-1] - beta[1:]) if K > 1 else beta
        step0 = 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for n_steps in (100, 20):
            if n_steps == 20:
                read_tiles(slib)               # from here on
            bar = torch.zeros(1, dtype=torch.int32, device="cuda")
            ev[0].record()
            err = slib.launch_stretch_steps(
                x.data_ptr(), lp.data_ptr(), acc.data_ptr(),
                sacc.data_ptr(), beta.data_ptr(), db.data_ptr(), K, W,
                seed, step0, n_steps, 0, None, None, 0.70710677, 0.70710677,
                0, 0, 0, bar.data_ptr(), c.buf.data_ptr(), c.params.iv_ptr,
                c.params.fv_ptr, torch.cuda.current_stream().cuda_stream,
                ctypes.byref(picked))
            if err:
                raise RuntimeError(f"launch failed: cudaError {err}")
            ev[1].record()
            torch.cuda.synchronize()
            step0 += n_steps
        tile_spread(slib, 40, f"step kernel at K={K}, W={W}, steps 100-119",
                    card)
        clk = (ctypes.c_longlong * N_CLOCKS)()
        if slib.read_phase_clocks(clk):
            raise RuntimeError("could not read the phase clocks")
        t = [clk[i] for i in ORDER]
        print("  block 0's last tile: " + ", ".join(
            f"{name} {b - a}" for name, a, b in zip(PHASES, t[:-1], t[1:])))
        print(f"  the 20 steps: {1e3 * ev[0].elapsed_time(ev[1]) / 20:.2f} "
              f"us a step (CUDA events, the probe build)" + (
                  f"; block 0's last swap sweep {clk[15] - clk[14]} SM "
                  f"cycles" if K > 1 else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
