"""Simulation-based calibration (Talts et al. 2018, arXiv:1804.06788).

Torch counterpart of ``joxsz_tpu/sampling/sbc.py``: end-to-end
validation of the inference pipeline.  If theta* ~ prior and data ~
p(data | theta*), the rank of theta*_i among L posterior draws given that
data is uniform on {0, ..., L} for every parameter; a likelihood /
simulator mismatch, a sampler bias or a prior / veto inconsistency shows
as a non-uniform rank histogram (U-shape: posterior too narrow; hump:
too wide; slope: biased).

The study: N exact prior draws (``sampling/priors.py``, on the numpy
seed, in the JAX package's order of calls), N mock datasets through the
likelihood's own forward models (``simulate.simulate_survey``), and N
ensembles fit at once on the stacked data.  On the card the N
replications run on the cluster-grid step kernel (kernel 4: the survey's
kernel route, ``sampling.kernel.fit_multicluster_kernel``, one launch per
chunk for all N), with the walkers' init and first log-posteriors
through the joint-likelihood kernel; a stack outside the kernel's
specialisation raises ``StackMismatch`` there, with no fallback.  On the
CPU they run the plain batched ensembles (``sampling/batched.py``).

The kernels compute in float32.  At the corners of the production prior
box n_e^2 underflows float32 at the outer radii (n_e ~ 1e-25 cm^-3 at
log(n_0) near -7) and the hydrostatic mass passes 3.4e38; the kernels'
mass veto forms n_e from ln n_e^2 there and compares a scaled mass, as
a signed logarithm where the product leaves float32's range
(``csrc/joint_ll.cuh``), so it keeps every draw of the production box
the float64 model keeps, apart from near-ties float32 cannot resolve
(``tests/test_torch_veto_box.py``: none at its seed).  A prior that reaches another
float32 limit would bias the ranks, so on the card ``run_sbc`` first
checks F32_CHECK_DRAWS prior draws (``float32_vetoed``) and refuses a
prior of which kernel 1 loses more than F32_VETO_TOLERANCE.  It then
checks its replications' mock data (``float32_misfits``): at the
production box's corners the forward models predict SZ fluxes up to
~1e17 mJy and beyond (a median of 1.6e17 over 256 replications on the
synthetic CL J1226), whose residuals against ~1 mJy errors no float32
arithmetic resolves, and kernel 1's log-posterior at the truth misses
the float64 model's by more than 1e6 in most replications; a prior
whose replications kernel 1 cannot evaluate is refused too.

Differences from the JAX function: ``run_sbc`` takes the ``FitSession``
(the kernel route packs its constants from it), and it has no
``flatten`` switch (the port's multicluster likelihood has one layout).

Posterior draws of one ensemble are autocorrelated, which does not bias
the ranks but shrinks the number of independent draws the chi^2 test
assumes: choose ``thin`` of order tau.  Ranks break ties uniformly, so
discrete ties (veto plateaus) cannot fake uniformity.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .batched import batched_init, run_batched_ensembles  # noqa: F401 (re-exported)
from .priors import model_log_prior, sample_prior

# prior draws held against the float32 kernels before SBC runs on them
F32_CHECK_DRAWS = 4096
# below this a log-posterior is zero probability in any precision
NEGLIGIBLE_LP = -1e30
# the share of those draws the float32 kernels may veto: far below what
# SBC's rank histograms resolve at any affordable number of replications
# (and the share of replications whose mock data they may misfit)
F32_VETO_TOLERANCE = 0.01
# kernel 1's log-posterior at a replication's truth against the float64
# model's: kernel 1's bar against float64 (chip_smoke.py phase 3)
F32_MOCK_RTOL, F32_MOCK_ATOL = 2e-4, 0.5


@dataclasses.dataclass
class SBCResult:
    ranks: np.ndarray          # (N, D) in {0..n_draws}
    n_draws: int               # L: posterior draws per replication
    thetas_true: np.ndarray    # (N, D) prior draws that generated the data
    p_values: np.ndarray       # (D,) chi^2 uniformity p-value per parameter
    counts: np.ndarray         # (D, B) binned rank histogram
    names: list[str]           # thawed parameter names
    acceptance: np.ndarray     # (N, W) sampler acceptance per replication

    def worst(self) -> tuple[str, float]:
        i = int(np.argmin(self.p_values))
        return self.names[i], float(self.p_values[i])


def sbc_uniformity(ranks: np.ndarray, n_draws: int,
                   n_bins: int | None = None):
    """Per-parameter chi^2 uniformity test of SBC ranks; returns
    (p_values (D,), counts (D, B)).  ``n_bins`` defaults to N // 20
    within [2, L + 1], so expected counts stay >= ~20."""
    from scipy import stats

    ranks = np.asarray(ranks)
    N, D = ranks.shape
    if n_bins is None:
        n_bins = int(np.clip(N // 20, 2, n_draws + 1))
    if not (2 <= n_bins <= n_draws + 1):
        raise ValueError(f"n_bins ({n_bins}) must be in [2, L+1]")
    # bin {0..L} into n_bins near-equal cells
    edges = np.floor(np.arange(1, n_bins) * (n_draws + 1) / n_bins)
    idx = np.searchsorted(edges, ranks, side="right")       # (N, D)
    counts = np.stack([np.bincount(idx[:, d], minlength=n_bins)
                       for d in range(D)])
    # expected per-bin mass follows the (near-)equal cell widths
    widths = np.diff(np.concatenate([[0], edges, [n_draws + 1]]))
    expected = N * widths / (n_draws + 1)
    chi2 = ((counts - expected) ** 2 / expected).sum(axis=1)
    p = stats.chi2.sf(chi2, df=n_bins - 1)
    return p, counts


def _simulable(model, thetas: np.ndarray) -> np.ndarray:
    """(n,) whether the X-ray forward model predicts non-negative counts
    in every cell at each row (always, without X-ray data)."""
    if model.xray_data is None:
        return np.ones(len(thetas), dtype=bool)
    m64 = model.to(model.sz_data.L.device, torch.float64)
    with torch.no_grad():
        pred = m64.xray_profiles(torch.as_tensor(
            thetas, device=model.sz_data.L.device)).cpu().numpy()
    return np.all(pred.reshape(len(thetas), -1) >= 0, axis=1)


def prior_truths(model, n_reps: int, rng: np.random.Generator) -> np.ndarray:
    """(n_reps, D) exact prior draws of ``model`` (float64, on its
    device) that its X-ray forward model can simulate, redrawing the
    others, in the JAX package's order of draws from ``rng``."""
    lpri = model_log_prior(model)
    thetas, tries = [], 0
    while len(thetas) < n_reps:
        tries += 1
        if tries > 16:
            raise RuntimeError("prior draws keep failing the simulator's "
                               "positivity check; inspect the prior")
        cand = sample_prior(lpri, model.params, n_reps - len(thetas), rng)
        thetas.extend(cand[_simulable(model, cand)])
    return np.asarray(thetas)


def float32_vetoed(session, thetas: np.ndarray) -> tuple[int, int]:
    """(rows, of ``thetas`` (n, D), that kernel 1 makes -inf while the
    float64 model gives them a log-posterior above NEGLIGIBLE_LP; those
    rows), both on the session's device and data.  On a CPU session
    kernel 1 is its plain float32 version."""
    from ..ops.joint_kernel import joint_ll, pack_consts

    dev = session.device
    th = torch.as_tensor(np.asarray(thetas, dtype=np.float64), device=dev)
    with torch.no_grad():
        l64 = session.model.to(dev, torch.float64).log_like_batch(th)
        l32 = joint_ll(th.to(torch.float32), pack_consts(session, device=dev))
    live = l64 > NEGLIGIBLE_LP
    return int((live & ~torch.isfinite(l32)).sum()), int(live.sum())


def veto_margins(model, thetas: np.ndarray) -> np.ndarray:
    """(n,) float64 mass-veto margins of the rows ``thetas`` (n, D), on the
    host CPU: the least of the veto's differences (np.gradient of M on the
    pressure grid; for knot pressure each segment mass's rise and the last
    mass) over their largest magnitude.  A float32 verdict that differs
    from float64's at a margin near 0 sits on the veto's boundary."""
    m = model.to("cpu", torch.float64)
    pars = m.params.unpack(torch.as_tensor(np.asarray(thetas,
                                                      dtype=np.float64)))
    rv = getattr(m.pressure, "mass_veto_radii", None)
    with torch.no_grad():
        if rv is not None:
            M = m.mass(pars, torch.as_tensor(rv(), dtype=torch.float64))
            g = torch.cat([M[:, 1:] - M[:, :-1], M[:, -1:]], dim=1).numpy()
        else:
            g = np.gradient(m.mass(pars, m.sz_data.r_press_kpc).numpy(),
                            axis=1)
    return g.min(axis=1) / np.abs(g).max(axis=1)


def float32_misfits(session, thetas: np.ndarray, survey) -> tuple[int, int]:
    """(replications whose mock data kernel 1 cannot evaluate,
    replications): kernel 1's float32 log-posterior at a replication's
    truth ``thetas`` (n, D) on its mock data (``survey``, as
    ``sbc_mocks`` makes it) is -inf or further than F32_MOCK_RTOL |lp| +
    F32_MOCK_ATOL from the float64 model's.  On a CPU session kernel 1
    is its plain float32 version."""
    from ..models.multicluster import make_multicluster_log_like
    from ..ops.joint_kernel import pack_consts_stack
    from ..ops.multicluster_kernel import multicluster_ll

    dev = session.device
    th = torch.as_tensor(np.asarray(thetas, dtype=np.float64),
                         device=dev)[:, None]
    # mock fluxes past float32's range become inf in the constants, and
    # then a misfit
    with torch.no_grad(), np.errstate(over="ignore"):
        l64 = make_multicluster_log_like(
            session.model.to(dev, torch.float64), survey.sz_stack,
            survey.xray_stack)(th)[:, 0]
        stack = pack_consts_stack(session, survey.sz_stack,
                                  survey.xray_stack)
        l32 = multicluster_ll(th.to(torch.float32).contiguous(),
                              stack)[:, 0].to(torch.float64)
    ok = torch.isfinite(l32) & ((l32 - l64).abs()
                                <= F32_MOCK_ATOL + F32_MOCK_RTOL * l64.abs())
    return int((~ok).sum()), th.shape[0]


def sbc_mocks(model, n_reps: int, seed: int, *, sz_noise: bool = True,
              xray_noise: bool = True):
    """``(thetas_true (n_reps, D), survey)``: SBC's prior draws and their
    mock datasets, both from the numpy generator on ``seed``."""
    from ..simulate import simulate_survey

    rng = np.random.default_rng(seed)
    thetas_true = prior_truths(model, n_reps, rng)
    return thetas_true, simulate_survey(model, thetas_true, rng,
                                        sz_noise=sz_noise,
                                        xray_noise=xray_noise)


def run_sbc(session, n_reps: int, *, n_walkers: int = 64,
            n_burn: int = 2000, n_steps: int = 500, thin: int = 50,
            seed: int = 0, sz_noise: bool = True, xray_noise: bool = True,
            init_spread: float = 0.05, n_bins: int | None = None) -> SBCResult:
    """Full SBC study of a session's joint model on its device.

    For each of ``n_reps`` replications: theta* ~ normalized prior, one
    mock dataset at theta*, an (``n_burn`` + ``n_steps``)-step ensemble
    fit, and the per-parameter rank of theta* among the L = (n_steps /
    thin) * n_walkers thinned post-burn draws.  Prior draws the forward
    model cannot evaluate (negative predicted X-ray counts at extreme but
    unvetoed corners) are redrawn: the prior conditioned on simulability
    is the measure calibrated, and the same positivity veto zeroes those
    points' likelihood.

    On the card the fits run in float32 on kernel 4; a prior of which
    kernel 1 vetoes more than F32_VETO_TOLERANCE of F32_CHECK_DRAWS draws
    (on ``seed + 2``) that the float64 model accepts raises
    ``ValueError`` first, and so do replications more than that share of
    whose mock data kernel 1 cannot evaluate (``float32_misfits``)."""
    from ..models.multicluster import make_multicluster_log_like
    from .kernel import fit_multicluster_kernel

    model = session.model
    dev = session.device
    if dev.type == "cuda":
        check = sample_prior(model_log_prior(model), model.params,
                             F32_CHECK_DRAWS,
                             np.random.default_rng(seed + 2))
        lost, live = float32_vetoed(session, check)
        if lost > F32_VETO_TOLERANCE * live:
            raise ValueError(
                f"kernel 1 (float32) makes {lost} of {live} prior draws "
                "-inf that the float64 model accepts: this prior reaches "
                "past float32's range in the likelihood, and SBC on the "
                "kernels would not calibrate it; narrow the prior box or "
                "run on the CPU")
    thetas_true, survey = sbc_mocks(model, n_reps, seed, sz_noise=sz_noise,
                                    xray_noise=xray_noise)
    if dev.type == "cuda":
        bad, n = float32_misfits(session, thetas_true, survey)
        if bad > F32_VETO_TOLERANCE * n:
            raise ValueError(
                f"kernel 1 (float32) cannot evaluate the mock data of {bad} "
                f"of {n} replications: its log-posterior at the truth is "
                f"-inf or misses the float64 model's by more than "
                f"{F32_MOCK_RTOL:g} |lp| + {F32_MOCK_ATOL:g} (model fluxes "
                "past float32's precision against their errors); SBC on "
                "the kernels would not calibrate this prior; narrow the "
                "prior box or run on the CPU")
        chain, _, acc, _, _ = fit_multicluster_kernel(
            session, survey.sz_stack, survey.xray_stack, thetas_true,
            n_walkers=n_walkers, n_burn=n_burn, n_steps=n_steps, thin=thin,
            seed=seed, init_spread=init_spread)
    else:
        llcb = make_multicluster_log_like(model, survey.sz_stack,
                                          survey.xray_stack)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        with torch.no_grad():
            p0 = batched_init(llcb, thetas_true, n_walkers, gen, device=dev,
                              dtype=model.sz_data.L.dtype,
                              spread=init_spread)
            chain, _, acc, _ = run_batched_ensembles(llcb, p0, n_burn,
                                                     n_steps, gen, thin=thin)
    # (n_saved, C, W, D) -> (C, L, D)
    draws = chain.transpose(1, 0, 2, 3).reshape(n_reps, -1,
                                                thetas_true.shape[1])
    L = draws.shape[1]
    # uniform tie-break: rank = #{draw < theta*} + #{draw == theta*} * U
    lt = (draws < thetas_true[:, None, :]).sum(axis=1)
    eq = (draws == thetas_true[:, None, :]).sum(axis=1)
    u = np.random.default_rng(seed + 1).random(lt.shape)
    ranks = lt + np.floor(u * (eq + 1)).astype(int)

    p_values, counts = sbc_uniformity(ranks, L, n_bins=n_bins)
    return SBCResult(ranks=ranks, n_draws=L, thetas_true=thetas_true,
                     p_values=p_values, counts=counts,
                     names=list(model.params.thawed), acceptance=acc)
