"""Port parity at other clusters' geometries: the counterpart of
``tests/test_geometry_sweep.py``.

Every other ``test_torch_*`` file holds the port at the synthetic CL J1226
shapes or near them.  Here ``joxsz_torch.synth.write_synthetic_dataset``
writes whole synthetic instruments at the JAX sweep's six corners (the
same axis values: table nT, annuli, bands, map pixel, SZ radius, beam,
extent, redshift, NH 0.03, 40 SZ points) and at two more that reach the
families the port runs through ``*_fam_kernel`` (line_scale; config #4,
knots + Vikhlinin T), each on the synthetic response with its count-rate
table generated at the corner's bands, nT, z and NH and kept, so that both
packages load the same file (the JAX sweep needs the real RMF and skips
its joint corners without it).  At every corner, with identical vetoes at
every stage:

* the port's float64 ``log_like_batch`` against the JAX package's float64
  ``log_like`` on the JAX sweep's cloud (six points within 2% of the
  synthetic truth, clipped strictly inside the box) at rtol 1e-9;
* ``joint_ll_plain`` (the float32 arithmetic of the CUDA kernel) against
  ``make_joint_core`` in interpret mode at rtol 2e-4 / atol 0.5 (the JAX
  sweep's bar), the JAX kernel declining nothing, and the vetoes the
  JAX package's float32 ``log_like`` gives;
* the packing: the sizes the kernels read and the launch plan the card
  takes (``consts_layout.launch_plan`` at the H100's shared memory): the
  large-map corner is the one that leaves shared memory (the constants
  read in place: the ``_large_`` instances).

The plain step kernel (``steps_plain`` at K=1 and K=4, 5 steps) is held on
two corners against one step at a time of ``sampling.stretch`` and
``sampling.tempered`` on the same Philox bits, as at the CL J1226 shapes.

The JAX file's 20-configuration randomized sweep (the same draws) is
marked ``slow``, as there.  ``test_phase_26_on_card`` runs the card's
side (``chip_smoke.py --only 26``) and skips without a card.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from joxsz_torch.build import build_session
from joxsz_torch.ops.consts_layout import launch_plan
from joxsz_torch.ops.joint_kernel import joint_ll_plain, pack_consts
from joxsz_torch.ops.step_kernel import philox_stream, stretch_steps
from joxsz_torch.sampling.kernel import rung_tensors
from joxsz_torch.sampling.stretch import ensemble_step, uniforms
from joxsz_torch.sampling.tempered import (default_betas, rotation_shift,
                                           swap_update)
from joxsz_torch.synth import (CORNER_DEFAULTS, CORNERS, truth_theta,
                               write_corner)
from joxsz_tpu.ops.pallas_joint import make_joint_core

from test_torch_build import jax_session

RTOL64 = 1e-9                   # the port's f64 model vs JAX f64 (PR 1)
RTOL, ATOL = 2e-4, 0.5          # float32 kernel vs kernel (the JAX sweep)
REPO = pathlib.Path(__file__).resolve().parents[1]

# the sizes each corner (synth.CORNERS) gives the kernels, (n_pix,
# n_press, n_data, n_sh), and the launch plan of the step kernel and
# kernel 1 on an H100 ('staged': everything in shared memory; 'in place':
# the constants read from global memory, the _large_ instances)
EXPECT = {
    "nT32": ((41, 59, 40, 8), "staged"),
    "nT96_many_annuli": ((99, 103, 40, 24), "staged"),
    "large_map": ((195, 200, 40, 15), "in place"),
    "knots": ((70, 99, 40, 10), "staged"),
    "double_density": ((77, 84, 40, 9), "staged"),
    "sz_only": ((113, 144, 40, 0), "staged"),
    "line_scale": ((87, 91, 23, 13), "staged"),
    "config4": ((116, 133, 31, 11), "staged"),
}


def cloud(sess, rng, n: int = 6) -> np.ndarray:
    """The JAX sweep's cloud: n points within 2% of the synthetic truth,
    clipped strictly inside the box."""
    th0 = truth_theta(sess)
    batch = th0[None] * (1 + 0.02 * rng.standard_normal((n, th0.size)))
    lo, hi = sess.params.lo, sess.params.hi
    span = np.where(np.isfinite(hi - lo), hi - lo, 1.0)
    return np.clip(batch,
                   np.where(np.isfinite(lo), lo + 1e-6 * span, -np.inf),
                   np.where(np.isfinite(hi), hi - 1e-6 * span, np.inf))


def check_corner(root, seed: int, dims: dict):
    """Build one corner and hold the port against the JAX package at every
    stage; returns (port f64 session, its kernel constants)."""
    cfg, sz_only = write_corner(str(root), seed, dims)
    sess = build_session(cfg, device="cpu", sz_only=sz_only)
    js64 = jax_session(cfg, sz_only=sz_only)
    batch = cloud(sess, np.random.default_rng(seed))
    a = sess.model.log_like_batch(torch.tensor(batch)).numpy()
    b = np.asarray(jax.jit(jax.vmap(js64.log_like))(jnp.asarray(batch)))
    fin = np.isfinite(b)
    assert fin.any(), f"no finite log-like in the cloud at {dims}"
    assert np.array_equal(np.isfinite(a), fin), (a, b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL64, atol=0)

    c = pack_consts(sess)
    js32 = jax_session(cfg, "float32", sz_only=sz_only)
    core = make_joint_core(js32, block_b=8, interpret=True)
    assert core is not None, f"the JAX kernel declined the corner {dims}"
    b32 = batch.astype(np.float32)
    k = np.asarray(core(jnp.asarray(b32)))
    x = np.asarray(jax.jit(jax.vmap(js32.log_like))(jnp.asarray(b32)))
    p = joint_ll_plain(torch.tensor(b32), c).numpy()
    fin32 = np.isfinite(k)
    for other in (p, x, a):
        assert np.array_equal(np.isfinite(other), fin32), (k, other)
    np.testing.assert_allclose(p[fin32], k[fin32], rtol=RTOL, atol=ATOL)
    return sess, c


@pytest.mark.parametrize("name", sorted(CORNERS))
def test_corner_matches_jax(tmp_path, name):
    dims = CORNERS[name]
    sizes, plan = EXPECT[name]
    _, c = check_corner(tmp_path, sorted(CORNERS).index(name) + 1, dims)
    I = c.ints
    assert (I["n_pix"], I["n_press"], I["n_data"], I["n_sh"]) == sizes
    want = dict(CORNER_DEFAULTS, **dims)
    assert (I["n_band"], I["nT"]) == ((0, 0) if dims.get("sz_only") else
                                      (want["n_bands"], want["nT"]))
    for kernel in ("stretch_steps", "joint_ll"):
        assert launch_plan(c.params, kernel) == plan, kernel


def _reference_steps(x, lp, betas, seed: int, n_steps: int, lp_fn):
    """n_steps steps, one at a time, from ``sampling.stretch.ensemble_step``
    (both half-steps) and ``sampling.tempered.swap_update`` at the step
    kernel's Philox counters (``ops.step_kernel`` docstring)."""
    K, W, D = x.shape
    H = W // 2
    bits = philox_stream(seed, "cpu")
    beta = torch.tensor(np.asarray(betas), dtype=torch.float32)
    acc = torch.zeros((K, W))
    db = (beta[:-1] - beta[1:]).tolist()
    frames = []
    for step in range(n_steps):
        u = torch.stack([uniforms(bits(step, which, K * H, 4)[:, :3])
                         .reshape(K, H, 3) for which in (0, 1)])
        x, lp, acc = ensemble_step(lp_fn, x, lp, acc, u, beta[:, None])
        for kk in range(K - 1):
            us = torch.stack([bits(step, 16 + 2 * kk + hb, H, 1)[:, 0]
                              for hb in (0, 1)])
            x, lp, _, _ = swap_update(x, lp, kk,
                                      rotation_shift(seed, step, kk, H),
                                      uniforms(us), db[kk])
        frames.append(x[0].clone())
    return x, lp, acc, torch.stack(frames)


@pytest.mark.parametrize("name", ["nT32", "knots"])
@pytest.mark.parametrize("K", [1, 4])
def test_plain_steps_at_corner(tmp_path, name, K):
    """``stretch_steps`` on CPU tensors (the plain launch, 5 steps at thin
    1) equals the samplers' own steps on the same bits, bit for bit."""
    cfg, _ = write_corner(str(tmp_path), sorted(CORNERS).index(name) + 1,
                          CORNERS[name])
    sess = build_session(cfg, device="cpu")
    c = pack_consts(sess)
    W, n, seed = 16, 5, 9
    rng = np.random.default_rng(seed)
    th0 = truth_theta(sess)
    lp_fn = lambda th: joint_ll_plain(th, c)              # noqa: E731
    x0 = torch.tensor(th0, dtype=torch.float32).repeat(K * W, 1)
    lp0 = torch.full((K * W,), -float("inf"))
    while not bool(torch.isfinite(lp0).all()):      # redraw vetoed rows
        bad = ~torch.isfinite(lp0)
        x0[bad] = torch.tensor(th0 * (1 + 0.005 * rng.standard_normal(
            (int(bad.sum()), th0.size))), dtype=torch.float32)
        lp0[bad] = lp_fn(x0[bad])
    x0, lp0 = x0.reshape(K, W, -1), lp0.reshape(K, W)
    betas = default_betas(K) if K > 1 else [1.0]
    beta, db = rung_tensors(betas, "cpu")
    x, lp, acc = x0.clone(), lp0.clone(), torch.zeros((K, W))
    sacc = torch.zeros(max(K - 1, 1), dtype=torch.int32)
    chain, _ = stretch_steps(x, lp, acc, sacc, beta, db, seed, n, c, thin=1)
    rx, rlp, racc, frames = _reference_steps(x0, lp0, betas, seed, n, lp_fn)
    assert torch.equal(x, rx) and torch.equal(lp, rlp)
    assert torch.equal(acc, racc) and torch.equal(chain, frames)
    assert 0 < float(acc.sum()) < K * W * n


# --- slow: the JAX file's randomized 20-configuration sweep --------------

@pytest.mark.slow
@pytest.mark.parametrize("seed", range(100, 120))
def test_sweep_randomized(tmp_path, seed):
    """The draws of ``tests/test_geometry_sweep.py::test_sweep_randomized``
    (the bands the geometric ``bands_between`` of the drawn count)."""
    rng = np.random.default_rng(seed)
    dims = dict(
        step_arcsec=float(rng.uniform(2.0, 8.0)),
        max_radius_arcsec=float(rng.uniform(150.0, 450.0)),
        n_sz=int(rng.integers(20, 80)),
        fwhm_arcsec=float(rng.uniform(8.0, 25.0)),
        extent_kpc=float(rng.uniform(1500.0, 4500.0)),
        n_annuli=int(rng.integers(8, 25)),
        n_bands=int(rng.integers(3, 13)),
        nT=int(rng.choice([32, 64, 96])),
        redshift=float(rng.uniform(0.2, 1.2)),
        nh_1022=float(rng.uniform(0.005, 0.1)),
    )
    if rng.random() < 0.25:
        dims.update(pressure_model="knots",
                    n_pressure_knots=int(rng.integers(3, 10)))
    check_corner(tmp_path, seed, dims)


@pytest.mark.gpu
def test_phase_26_on_card():
    """The card's side of this file: ``chip_smoke.py --only 26`` holds
    every kernel at these corners against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--only", "26"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=1200, env=dict(os.environ))
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert '"ok": true' in out.stdout.strip().splitlines()[-1]
