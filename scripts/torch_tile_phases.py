"""Where a likelihood tile and a swap sweep spend their time on the card.

Builds ``joxsz_torch/csrc/joint_ll.cu`` and ``stretch_step.cu`` once more
with ``-DJT_PHASE_CLOCKS`` (thread 0 of block 0 records ``clock64()`` at
each phase boundary of ``joint_ll_tile`` and around the swap sweep) into
``build/phase_probe/``, runs kernel 1 on the synthetic CL J1226 dataset
(seed 11) at 16 rows (one tile on an idle card) and at 4096 rows (block
0's last tile among a full grid), and one step of the step kernel at K=4,
W=1024, and prints the SM cycles of each phase, their share of the tile,
the sweep's cycles, and the card's SM clock and power limit beside them.

    python3 scripts/torch_tile_phases.py
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


def main() -> int:
    import torch
    from joxsz_torch.build import build_session
    from joxsz_torch.ops import _build
    from joxsz_torch.ops.joint_kernel import pack_consts
    from joxsz_torch.synth import TRUTH, write_synthetic_dataset

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
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
        clk = (ctypes.c_longlong * 16)()
        if lib.read_phase_clocks(clk):
            raise RuntimeError("could not read the phase clocks")
        t = [clk[i] for i in ORDER]
        total = t[-1] - t[0]
        print(f"kernel 1 at {B} rows: a tile takes {total} SM cycles; "
              f"{card} (name, power limit, SM clock now)")
        for name, a, b in zip(PHASES, t[:-1], t[1:]):
            print(f"  {name:32s} {b - a:8d} cycles  "
                  f"{100 * (b - a) / total:5.1f}%")
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
    clk = (ctypes.c_longlong * 16)()
    if slib.read_phase_clocks(clk):
        raise RuntimeError("could not read the phase clocks")
    print(f"step kernel at K={K}, W={W}: block 0's tile {clk[13] - clk[0]} "
          f"SM cycles, the swap sweep (3 boundaries) {clk[15] - clk[14]} "
          f"SM cycles; {card}")
    t = [clk[i] for i in ORDER]
    for name, a, b in zip(PHASES, t[:-1], t[1:]):
        print(f"  {name:32s} {b - a:8d} cycles  "
              f"{100 * (b - a) / (t[-1] - t[0]):5.1f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
