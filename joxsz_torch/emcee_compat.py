"""Drop-in ``emcee``-style API over the port's plain ensemble sampler.

Torch counterpart of ``joxsz_tpu/emcee_compat.py``.  The reference
drives its MCMC through ``emcee.EnsembleSampler`` with a
``multiprocessing.Pool`` (reference joxsz_main.py:203-214) and reads
emcee's accessors (``chain``, ``flatchain``, ``acceptance_fraction``).
Scripts migrating find that surface here, backed by
``sampling.stretch.run_ensemble`` (the stretch move and emcee's DE /
snooker moves) on a batched likelihood on the card.

Differences from emcee (deliberate):

* ``log_prob_fn`` is a torch function.  With ``vectorize=True`` it maps
  (W, D) -> (W,); otherwise it maps one (D,) tensor to a scalar and is
  batched with ``torch.func.vmap`` (so no data-dependent Python
  branching on the values).
* ``device=`` says where the walkers live (default: the card, which must
  be present; ``"cpu"`` to run here); ``dtype`` defaults to torch's
  default float type.
* randomness is a ``torch.Generator`` seeded from ``seed=`` (constructor
  or ``run_mcmc``), not numpy's global state: chains are reproducible
  per seed, not bit-matched to emcee's stream.
* ``moves`` takes a move name — 'stretch' (emcee's ``StretchMove``),
  'de' (``DEMove``), 'snooker' (``DESnookerMove``) — a bare ``(name,
  param)`` tuple carrying the move parameter (stretch scale ``a`` / DE
  gamma), or a singleton ``[(name, weight)]`` list in emcee's mixture
  form (the weight of a one-move mixture is ignored).  Weighted mixtures
  are not supported.
* ``sample()`` yields every ``thin_by`` steps, each yield a device ->
  host copy: prefer ``run_mcmc``.
"""

from __future__ import annotations

import numpy as np
import torch

from .sampling.stretch import run_ensemble, validate_schedule

__all__ = ["EnsembleSampler", "State"]


class State:
    """emcee.State equivalent: coords/log_prob/random_state triplet."""

    def __init__(self, coords, log_prob=None, random_state=None):
        self.coords = np.asarray(coords)
        self.log_prob = None if log_prob is None else np.asarray(log_prob)
        self.random_state = random_state

    def __repr__(self):  # pragma: no cover - debugging nicety
        return (f"State(coords={self.coords.shape}, "
                f"log_prob={None if self.log_prob is None else self.log_prob.shape})")


_MOVE_NAMES = ("stretch", "de", "snooker")


def _resolve_move(moves):
    """Returns (name, stretch_a, de_gamma).

    A bare ``(name, number)`` tuple carries the move's parameter (the
    stretch scale ``a``, or the DE/snooker gamma).  A singleton list
    ``[(name, weight)]`` is emcee's mixture form: the weight of a
    one-element mixture is ignored, never read as a scale
    (``[('stretch', 1.0)]`` must not freeze the sampler at a=1)."""
    if moves is None:
        return "stretch", 2.0, None
    if isinstance(moves, str):
        if moves not in _MOVE_NAMES:
            raise ValueError(f"unknown move {moves!r}: expected one of "
                             f"{_MOVE_NAMES}")
        return moves, 2.0, None
    if isinstance(moves, list) and len(moves) == 1:
        item = moves[0]
        if isinstance(item, str):
            return _resolve_move(item)
        if (isinstance(item, (list, tuple)) and len(item) == 2
                and isinstance(item[0], str)):
            # [(name, weight)] — mixture weight, ignored for a singleton
            return _resolve_move(item[0])
    if (isinstance(moves, tuple) and len(moves) == 2
            and isinstance(moves[0], str)
            and isinstance(moves[1], (int, float))):
        name, val = moves
        if name == "stretch":
            a = float(val)
            if a <= 1.0:
                raise ValueError(
                    f"stretch scale a must be > 1 (got {a}); to pass a "
                    "mixture weight use the list form [('stretch', w)]")
            return name, a, None
        if name in _MOVE_NAMES:
            return name, 2.0, float(val)       # DE/snooker gamma
    raise ValueError(
        f"unsupported moves spec {moves!r}: pass 'stretch', 'de', "
        "'snooker', a (name, param) tuple, or a singleton "
        "[(name, weight)] list — weighted move mixtures are not "
        "supported")


class EnsembleSampler:
    """emcee.EnsembleSampler work-alike (the reference call site's
    constructor signature; ``pool`` and ``backend`` are accepted and
    ignored — batching replaces the pool, and ``io.checkpoint`` covers
    persistent chains)."""

    def __init__(self, nwalkers, ndim, log_prob_fn, pool=None, args=None,
                 kwargs=None, moves=None, vectorize=False, backend=None,
                 seed=0, dtype=None, device=None):
        from .device import resolve_device

        if nwalkers % 2:
            raise ValueError("need an even number of walkers")
        if nwalkers < 2 * ndim + 2:
            # fewer walkers cannot span the parameter space under
            # affine-invariant moves
            raise ValueError(f"nwalkers ({nwalkers}) must be >= "
                             f"2*ndim+2 ({2 * ndim + 2})")
        self.nwalkers = int(nwalkers)
        self.ndim = int(ndim)
        self._move, self._a, self._de_gamma = _resolve_move(moves)
        self._seed = int(seed)
        self._device = resolve_device(device)
        self._dtype = dtype if dtype is not None else torch.get_default_dtype()
        args = tuple(args or ())
        kwargs = dict(kwargs or {})

        if vectorize:
            def batched(x):
                return log_prob_fn(x, *args, **kwargs)
        else:
            batched = torch.func.vmap(
                lambda x: log_prob_fn(x, *args, **kwargs))
        self._log_prob_batch = batched

        self._chain = None          # (n_saved, W, D) accumulated host-side
        self._log_prob = None       # (n_saved, W)
        self._acc_counts = np.zeros(self.nwalkers)
        self._n_steps_run = 0
        self._rng_calls = 0         # monotone; survives reset() so the
        self._last = None           # State  burn/reset/sample idiom never
        #                             replays the burn-in's stream

    # -- emcee accessors ---------------------------------------------------

    @property
    def acceptance_fraction(self):
        n = max(self._n_steps_run, 1)
        return self._acc_counts / n

    def get_chain(self, flat=False, thin=1, discard=0):
        if self._chain is None:
            raise AttributeError("no chain stored yet: run run_mcmc first")
        # emcee's backend thinning selects frames [discard+thin-1 :: thin]
        c = self._chain[discard + thin - 1::thin]
        if flat:
            return c.reshape(-1, self.ndim)
        return c

    def get_log_prob(self, flat=False, thin=1, discard=0):
        if self._log_prob is None:
            raise AttributeError("no chain stored yet: run run_mcmc first")
        lp = self._log_prob[discard + thin - 1::thin]
        return lp.reshape(-1) if flat else lp

    @property
    def chain(self):
        """emcee v2 layout (nwalkers, n_saved, ndim) — the reference
        reshapes this with order='F' (joxsz_main.py:213)."""
        return np.transpose(self.get_chain(), (1, 0, 2))

    @property
    def flatchain(self):
        return self.get_chain(flat=True)

    @property
    def lnprobability(self):
        return np.transpose(self.get_log_prob(), (1, 0))

    def get_last_sample(self):
        return self._last

    def get_autocorr_time(self, discard=0, thin=1, quiet=False, **_):
        """Integrated autocorrelation time per parameter, in units of
        stored samples x ``thin`` (emcee's convention), by the shared tau
        rules of ``postproc.summary``."""
        from .postproc.summary import chain_tau_steps

        c = self.get_chain(discard=discard, thin=thin)
        if c.shape[0] < 4:
            raise RuntimeError(
                f"chain too short for any tau estimate "
                f"({c.shape[0]} stored draws < 4); run longer")
        tau = chain_tau_steps(c, 1)       # units of the (re-thinned) chain
        if not quiet and c.shape[0] < 20 * float(np.max(tau)):
            raise RuntimeError(
                f"chain too short for a reliable tau estimate "
                f"({c.shape[0]} stored < 20*tau={20 * float(np.max(tau)):.0f}); "
                "pass quiet=True to get the noisy value anyway")
        return tau * thin

    def reset(self):
        self._chain = None
        self._log_prob = None
        self._acc_counts = np.zeros(self.nwalkers)
        self._n_steps_run = 0

    # -- running -----------------------------------------------------------

    def _coerce_initial(self, initial_state):
        if initial_state is None:
            if self._last is None:
                raise ValueError("no previous state: pass initial_state")
            return self._last
        if isinstance(initial_state, State):
            return initial_state
        return State(np.asarray(initial_state))

    def _generator(self, seed) -> torch.Generator:
        """A continuation call must not replay the earlier stream (the
        call counter is folded into the seed); an explicit ``seed`` is a
        reproducibility request and gives the same chain whatever ran
        before."""
        if seed is None:
            s = int(np.random.SeedSequence(
                [self._seed, self._rng_calls]).generate_state(1)[0])
        else:
            s = int(seed)
        self._rng_calls += 1
        gen = torch.Generator(device=self._device)
        gen.manual_seed(s)
        return gen

    def run_mcmc(self, initial_state, nsteps, thin_by=1, store=True,
                 progress=False, seed=None, **_):
        """Run ``nsteps * thin_by`` steps, storing every ``thin_by``-th
        (emcee's thin_by semantics); returns the final State."""
        state = self._coerce_initial(initial_state)
        total = int(nsteps) * int(thin_by)
        validate_schedule(total, int(thin_by), self.nwalkers)
        gen = self._generator(seed)
        p0 = torch.as_tensor(np.asarray(state.coords), dtype=self._dtype,
                             device=self._device)
        with torch.no_grad():
            res = run_ensemble(self._log_prob_batch, p0, total, gen,
                               thin=int(thin_by), a=self._a,
                               store_chain=store,
                               move=self._move, de_gamma=self._de_gamma)
        if store:
            self._chain = (res.chain if self._chain is None
                           else np.concatenate([self._chain, res.chain]))
            self._log_prob = (res.log_prob if self._log_prob is None
                              else np.concatenate([self._log_prob,
                                                   res.log_prob]))
        self._acc_counts += res.acceptance_fraction * total
        self._n_steps_run += total
        self._last = State(res.final_state[0].cpu().numpy(),
                           res.final_state[1].cpu().numpy())
        return self._last

    def sample(self, initial_state, iterations=1, thin_by=1, store=True,
               progress=False, seed=None, **_):
        """emcee's generator API: yields a State every ``thin_by`` steps
        (each yield a device -> host copy; prefer ``run_mcmc``)."""
        state = self._coerce_initial(initial_state)
        for _i in range(int(iterations)):
            state = self.run_mcmc(state, 1, thin_by=thin_by, store=store,
                                  seed=seed)
            yield state
