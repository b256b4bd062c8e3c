"""Posterior-level referee of the port's device samplers.

The replicate scheme of ``tests/test_posterior_parity.py`` on the port:
an independent, plain numpy implementation of the Goodman-Weare stretch
move shares only the likelihood (kernel 1 through
``KernelSampler.log_prob_batch``, float32 on the card) with three arms of
the port's step kernel, and each arm must agree with it at the posterior
level, within bands calibrated on this exact schedule:

  * ``k1``: ``KernelSampler(partner="onehot").run`` at K=1, the sampler
    of the prelim rounds and the burn-in;
  * ``k4``: ``run_tempered_kernel`` on ``default_betas(4)``, the flagless
    fit's ladder with its swap sweep, compared on its cold rung;
  * ``roll``: ``KernelSampler(partner="roll").run`` at K=1, the hashed
    roll that production takes above 4096 walkers per rung.

The posterior is the synthetic CL J1226 one (``joxsz_torch.synth`` at
``DATA_SEED``) in ``REFEREE_BOX``, started around
``synth.truth_theta``.  A broken numpy move, its acceptance exponent
(d-1) -> (d+1), is the negative control: it must fail the width band.

Bands (``scripts/torch_parity_calibrate.py``, three realisations in
results/torch_parity_calibration_s{0,1000,2000}.json, on an NVIDIA H100
80GB HBM3 at 700 W; the files record the provisional bands of that run):

  * correct-vs-correct scatter, numpy vs numpy and each arm vs numpy:
    max |median diff| 0.037 / 0.047 / 0.022 / 0.041 widths (numpy, k1,
    k4, roll), max |log width ratio| 0.060 / 0.053 / 0.049 / 0.055,
    over the three realisations -- the bands carry >= 1.6x margin;
  * the (d-1) -> (d+1) control measures at max |log width ratio|
    0.162 / 0.267 / 0.162 against the k1 arm (0.126-0.273 against every
    correct set), carried by the parameters outside the box -- it fails
    the width band in all three.

This module imports torch, numpy and ``joxsz_torch`` only; pytest does
not collect it.  ``chip_smoke.py`` (phase 25) and the calibration script
put ``tests/`` on ``sys.path`` and import it.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

# the synthetic dataset's seed (chip_smoke.py's default --seed, so phase
# 25 runs on phase 2's dataset)
DATA_SEED = 11


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Walkers, burn-in and stored steps of every replicate, the frames
    kept for the summaries (every ``thin``-th step), and the replicates:
    of the referee, of each arm and of the control.  The defaults are
    ``tests/test_posterior_parity.py``'s schedule."""

    w: int = 256
    burn: int = 1000
    steps: int = 4000
    thin: int = 1
    k_ref: int = 3
    k_dev: int = 3
    k_ctrl: int = 2


# the schedule the bands are calibrated for: changing it (or the box)
# without re-running scripts/torch_parity_calibrate.py invalidates the
# bands.  On this posterior the K=1 stretch move's autocorrelation time
# is 943-3163 steps (results/torch_parity_long_40000.json), so the JAX
# test's 1000 + 4000 steps leave the K=1 chains short of equilibrium,
# where the tempered ladder is not; 10000 + 40000 brings the device arms
# within 0.05 of each other in the box below
# (results/torch_parity_box_scan_part.json).  The referee takes 6
# replicates: the K=4 arm's widths read +0.03-0.09 above the K=1 chains'
# on the slow, prior-dominated P_0 and beta in every realisation measured
# (the ladder mixes what the K=1 chains leave short), and at 3 replicates
# the referee's median width of P_0 scatters by ~0.03 more, which put the
# K=4 arm at 0.126 at seed base 0 with the mass veto's near-ties decided
# in float64; at 6, 0.068, and the two referee sets agree within 0.01
# (results/torch_parity_calibration_s0_ref6.json; seed bases 1000 and
# 2000 at 3 replicates, K=4 0.051 and 0.054:
# results/torch_parity_calibration_s*_near_ties.json)
SCHEDULE = Schedule(burn=10000, steps=40000, thin=10, k_ref=6)
# prior box of the referee's posterior: name -> (lo, hi), the session's
# box elsewhere.  The gNFW shape, epsilon and Z are prior-dominated on
# the synthetic data, and their tails (a and P_0 out to the production
# box's walls) stay unconverged for K=1 chains at 40000 steps (k4 / k1
# width 1.8); here they are boxed to +-1.5 posterior sds around the
# posterior median (the k4 arm's at 40000 steps), widened to hold the
# start ball (results/torch_parity_box_scan_part.json)
REFEREE_BOX = {r"\epsilon": (2.76, 10.0), "Z": (0.137, 0.826),
               "P_0": (0.0, 0.571), "a": (0.1, 3.69), "b": (1.13, 8.2),
               "r_p": (100.0, 2398.0)}
CTRL_OFFSET = 2                 # the control's exponent (d-1) -> (d+1)
N_RUNGS = 4                     # the k4 arm's ladder: default_betas(4)
MED_BAND = 0.08     # max |median diff| in pooled posterior widths
WIDTH_BAND = 0.10   # max |log width ratio|
ARMS = ("k1", "k4", "roll")


def stretch_moves(p0, n_steps, rng, a=2.0, z_exponent_offset=0, thin=1):
    """The referee's stretch sampler as a coroutine: it yields each batch
    of positions whose log-probabilities it needs (the walkers, then each
    half-step's proposals), takes them back through ``send`` and returns
    the chain of every ``thin``-th step.  The draws and the arithmetic are
    those of ``tests/test_posterior_parity.py::numpy_stretch_sampler``,
    step for step."""
    x = np.array(p0, dtype=float)
    n_w, d = x.shape
    h = n_w // 2
    expo = d - 1 + z_exponent_offset
    lp = np.array((yield x))
    chain = []
    for i in range(n_steps):
        for (m0, m1), (f0, f1) in (((0, h), (h, n_w)), ((h, n_w), (0, h))):
            mv = slice(m0, m1)
            nm = m1 - m0
            z = (1 / np.sqrt(a) + rng.random(nm)
                 * (np.sqrt(a) - 1 / np.sqrt(a))) ** 2
            partner = rng.integers(0, f1 - f0, nm)
            xp = x[f0:f1][partner]
            y = xp + z[:, None] * (x[mv] - xp)
            lp_y = np.asarray((yield y))
            accept = (np.log(rng.random(nm))
                      < expo * np.log(z) + lp_y - lp[mv])
            x[mv] = np.where(accept[:, None], y, x[mv])
            lp[mv] = np.where(accept, lp_y, lp[mv])
        if (i + 1) % thin == 0:
            chain.append(x.copy())
    return np.array(chain)


def run_lockstep(log_prob_batch, movers) -> list:
    """Drive ``stretch_moves`` coroutines together, one ``log_prob_batch``
    call for all their requests at a time (their draws stay their own, so
    each chain is the one it gives alone); returns their chains."""
    movers = list(movers)
    reqs = [next(m) for m in movers]
    chains = [None] * len(movers)
    live = list(range(len(movers)))
    while live:
        lp = log_prob_batch(np.concatenate([reqs[i] for i in live]))
        parts = np.split(lp, np.cumsum([len(reqs[i]) for i in live])[:-1])
        still = []
        for i, part in zip(live, parts):
            try:
                reqs[i] = movers[i].send(part)
                still.append(i)
            except StopIteration as stop:
                chains[i] = stop.value
        live = still
    return chains


def numpy_stretch_sampler(log_prob_batch, p0, n_steps, rng, a=2.0,
                          z_exponent_offset=0):
    """Independent reference implementation of the red-black stretch
    move (Goodman & Weare 2010; emcee's algorithm).  Only the LIKELIHOOD
    is shared with the device sampler: proposal, partner draw and
    acceptance are plain numpy.  ``log_prob_batch`` maps numpy float64
    (n, d) to numpy (n,).  ``z_exponent_offset`` breaks the acceptance
    exponent (d-1) -> (d-1+offset) for the negative control."""
    return run_lockstep(log_prob_batch, [stretch_moves(
        p0, n_steps, rng, a, z_exponent_offset)])[0]


def parity_stats(ma, sa, mb, sb):
    """(max |median diff| / width, max |log width ratio|): replicate-mean
    medians, replicate-MEDIAN widths (posterior widths are heavy-tailed
    run to run, so a mean would let one tail replicate dominate)."""
    wa = np.median(sa, axis=0)
    wb = np.median(sb, axis=0)
    width = 0.5 * (wa + wb)
    dmed = np.max(np.abs(ma.mean(0) - mb.mean(0)) / width)
    dwidth = np.max(np.abs(np.log(wa / wb)))
    return dmed, dwidth


def init(theta_c, rng, w=SCHEDULE.w):
    """Walkers 2% (relative) around the centre."""
    return theta_c[None] * (1 + 0.02 * rng.standard_normal((w, theta_c.size)))


def replicate_seeds(seed_base: int = 0) -> dict:
    """The generators' seeds of one realisation: the referee's walkers and
    draws (``ref``), a second referee set for the numpy-vs-numpy scatter
    (``ref2``), the arms' starting walkers (``dev``), their burn-in and
    sampling chunk seeds (``burn``, ``run``), the control (``ctrl``).
    ``seed_base`` 0 is the realisation the test and phase 25 reproduce;
    replicate r adds r to each."""
    return {k: seed_base + v for k, v in (
        ("ref", 100), ("ref2", 300), ("dev", 500), ("burn", 50),
        ("run", 150), ("ctrl", 7000))}


def session(root, device, seed: int = DATA_SEED, box=REFEREE_BOX, **shape):
    """``referee_session`` of the synthetic CL J1226 dataset written under
    ``root`` (``shape``: smaller sizes for the CPU, as
    ``synth.write_synthetic_dataset`` takes them)."""
    from joxsz_torch.synth import write_synthetic_dataset

    return referee_session(write_synthetic_dataset(str(root), seed,
                                                   **shape), device, box=box)


def referee_session(cfg, device, root=None, box=REFEREE_BOX):
    """(session, kernel constants, centre) of the referee's posterior: the
    dataset of ``cfg`` (None: the calibrated one, ``DATA_SEED``, written
    under ``root``) in the prior box ``box`` (name -> (lo, hi)), centred
    on ``synth.truth_theta``."""
    from joxsz_torch.build import build_session
    from joxsz_torch.ops.joint_kernel import pack_consts
    from joxsz_torch.synth import truth_theta, write_synthetic_dataset

    if cfg is None:
        cfg = write_synthetic_dataset(str(root), DATA_SEED)
    sess = build_session(cfg, device=device)
    if box:
        p = sess.params
        for name, (lo, hi) in box.items():
            p[name].minval, p[name].maxval = lo, hi
        p._refresh()
    return sess, pack_consts(sess), truth_theta(sess)


def referee_log_prob(consts):
    """The shared likelihood as the numpy referee takes it: numpy float64
    (n, D) -> numpy float64 (n,), through kernel 1 (its plain version on
    CPU constants)."""
    from joxsz_torch.sampling.kernel import KernelSampler

    sampler = KernelSampler(consts)

    def log_prob(x):
        return sampler.log_prob_batch(torch.from_numpy(x)).double().cpu() \
            .numpy()

    return log_prob


def arm_chain(arm: str, consts, p0, rng_burn, rng_run,
              sched: Schedule = SCHEDULE) -> np.ndarray:
    """One replicate of ``arm`` from walkers p0 (W, D): ``sched.burn``
    steps without storing, then ``sched.steps`` stored every
    ``sched.thin``-th, each chunk's Philox seed drawn from ``rng_burn`` /
    ``rng_run``.  Returns the (cold-rung) chain (steps // thin, W, D)."""
    from joxsz_torch.sampling.kernel import KernelSampler, run_tempered_kernel
    from joxsz_torch.sampling.tempered import default_betas

    if arm not in ARMS:
        raise ValueError(f"arm must be one of {ARMS}, got {arm!r}")
    sampler = KernelSampler(consts,
                            partner="roll" if arm == "roll" else "onehot")
    p0 = torch.as_tensor(p0, dtype=torch.float32)
    if arm == "k4":
        betas = default_betas(N_RUNGS)
        res = run_tempered_kernel(sampler, p0, betas, sched.burn, rng_burn,
                                  store_chain=False)
        res = run_tempered_kernel(sampler, res.final_state[0], betas,
                                  sched.steps, rng_run, thin=sched.thin)
    else:
        res = sampler.run(p0, sched.burn, rng_burn, store_chain=False)
        res = sampler.run(res.final_state[0], sched.steps, rng_run,
                          thin=sched.thin)
    return res.chain


def summarize(chain: np.ndarray):
    """(medians, widths) per parameter of a chain (n, W, D)."""
    flat = chain.reshape(-1, chain.shape[-1])
    return np.median(flat, axis=0), np.std(flat, axis=0)


def np_replicate_sets(log_prob, theta_c, sets: dict,
                      sched: Schedule = SCHEDULE) -> dict:
    """Replicate sets of the numpy referee, all driven in lockstep (one
    likelihood call per half-step for every replicate): ``sets`` maps a
    tag to (k, seed0, exponent offset); replicate r draws its walkers and
    its moves from ``default_rng(seed0 + r)``.  Returns tag ->
    {"medians" (k, D), "widths" (k, D), "wall" [s] of the whole group}."""
    movers, tags = [], []
    for tag, (k, seed0, offset) in sets.items():
        for r in range(k):
            rng = np.random.default_rng(seed0 + r)
            movers.append(stretch_moves(init(theta_c, rng, sched.w),
                                        sched.burn + sched.steps, rng,
                                        z_exponent_offset=offset,
                                        thin=sched.thin))
            tags.append(tag)
    t0 = time.perf_counter()
    chains = run_lockstep(log_prob, movers)
    wall = time.perf_counter() - t0
    out = {}
    for tag in sets:
        summ = [summarize(ch[sched.burn // sched.thin:])
                for ch, t in zip(chains, tags) if t == tag]
        out[tag] = {"medians": np.array([m for m, _ in summ]),
                    "widths": np.array([w for _, w in summ]), "wall": wall}
    return out


def device_replicates(arm: str, consts, theta_c, k: int, seed_base: int = 0,
                      sched: Schedule = SCHEDULE) -> dict:
    """k replicates of ``arm``: {"medians" (k, D), "widths" (k, D),
    "wall" [s]}; the wall ends in a synchronisation (the chains' fetch)."""
    s = replicate_seeds(seed_base)
    meds, stds = [], []
    t0 = time.perf_counter()
    for r in range(k):
        p0 = init(theta_c, np.random.default_rng(s["dev"] + r), sched.w)
        ch = arm_chain(arm, consts, p0, np.random.default_rng(s["burn"] + r),
                       np.random.default_rng(s["run"] + r), sched)
        m, sd = summarize(ch)
        meds.append(m)
        stds.append(sd)
    return {"medians": np.array(meds), "widths": np.array(stds),
            "wall": time.perf_counter() - t0}


def run_referee(consts, theta_c, seed_base: int = 0, arms=ARMS,
                second_reference: bool = False,
                sched: Schedule = SCHEDULE) -> dict:
    """Every replicate set of one realisation: ``"np"`` (the referee),
    one entry per arm, ``"ctrl"`` (the broken move) and, with
    ``second_reference``, ``"np2"`` (an independent referee set).  Each is
    a dict of medians, widths and the wall."""
    s = replicate_seeds(seed_base)
    sets = {"np": (sched.k_ref, s["ref"], 0)}
    if second_reference:
        sets["np2"] = (sched.k_ref, s["ref2"], 0)
    sets["ctrl"] = (sched.k_ctrl, s["ctrl"], CTRL_OFFSET)
    out = np_replicate_sets(referee_log_prob(consts), theta_c, sets, sched)
    for arm in arms:
        out[arm] = device_replicates(arm, consts, theta_c, sched.k_dev,
                                     seed_base, sched)
    return out


def stats(out: dict, a: str, b: str):
    """``parity_stats`` of replicate sets ``a`` and ``b`` of
    ``run_referee``'s result."""
    return parity_stats(out[a]["medians"], out[a]["widths"],
                        out[b]["medians"], out[b]["widths"])
