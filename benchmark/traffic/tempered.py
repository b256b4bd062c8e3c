"""Traffic kind ``tempered``: back-to-back sampling phases of one cluster
at the configuration's schedule (K rungs x W walkers, ``steps`` a phase,
frames every ``thin``), each continuing from the last phase's final
state, after ``equilibrium_phases`` phases of set-up from a small cloud
(``init_spread``) around the truth.  K > 1 runs
``sampling.kernel.run_tempered_kernel`` (the step kernel with its swap
sweep), K = 1 ``KernelSampler.run`` (the same kernel without one).

The traffic's numbers: ``init_spread``; ``check_frames``, the cold
(frame, walker) rows the check draws from the seed; ``move_draws``, the
stretch proposals the check draws from each walker of the final state;
``schedule``, keys that replace the configuration's."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import roofline
from benchmark.harness.jobs import (Moves, Rows, Swaps, other_half, part,
                                    program_session, stretch_proposals)
from benchmark.reference.data import write_dataset


class Jobs:
    kind = "tempered"

    def __init__(self, config: dict, traffic: dict, seed: int, workdir,
                 device):
        sch = dict(config["schedule"], **traffic.get("schedule", {}))
        self.K, self.W = sch["rungs"], sch["walkers"]
        self.steps, self.thin = sch["steps"], sch["thin"]
        self.a = float(sch["stretch_scale"])
        self.betas = sch["beta_ratio"] ** np.arange(self.K)
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.devices = [self.device]
        self.workdir = workdir
        self.evals_per_step = self.K * self.W
        self.launch_steps = []           # steps of each launch of a job
        self.setup_parts = {}

    def setup(self):
        from joxsz_torch.sampling.batched import batched_init
        from joxsz_torch.sampling.kernel import (make_kernel_sampler,
                                                 chain_chunk_schedule)

        t = time.perf_counter()
        self.cfg_path, base, truth = write_dataset(self.config, self.workdir)
        self.names = list(base.params.thawed)
        self.shapes = roofline.model_shapes(base)
        t = part(self.setup_parts, "data_s", t)
        self.sess = program_session(self.cfg_path, self.device, self.names)
        self.sampler = make_kernel_sampler(self.sess)
        t = part(self.setup_parts, "session_s", t)
        self.launch_steps = chain_chunk_schedule(self.steps, self.thin)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed)
        D = len(self.names)
        x = batched_init(
            lambda th: self.sampler.log_prob_batch(
                th.reshape(-1, D)).reshape(th.shape[:-1]),
            truth[None], self.K * self.W, gen, device=self.device,
            spread=float(self.traffic["init_spread"]))
        self.x = x.reshape(self.K, self.W, D)
        self.rng = np.random.default_rng([self.seed, 1])
        t = part(self.setup_parts, "start_s", t)
        for _ in range(self.config["equilibrium_phases"]):
            self.job(None)
        self.x0 = self.x.cpu().numpy()
        part(self.setup_parts, "burn_s", t)
        self.frames, self.frames_lp = [], []
        # the cold rung's accepted share over the window's phases,
        # weighted by their steps; every rung's, and every boundary's
        # swaps, over the last phase, which ends at the final state
        self.cold_acc_steps = 0.0
        self.window_steps = 0
        self.last_acc = self.last_swap = None

    def _phase(self):
        """One phase: ``(chain, log_prob, acceptance (K,), swap
        acceptance (K-1,))``, the state advanced."""
        from joxsz_torch.sampling.kernel import run_tempered_kernel

        if self.K == 1:
            res = self.sampler.run(self.x[0], self.steps, self.rng,
                                   thin=self.thin)
            x, lp = res.final_state
            self.x, self.lp = x[None], lp[None]
            return (res.chain, res.log_prob,
                    res.acceptance_fraction.mean(keepdims=True),
                    np.zeros(0))
        res = run_tempered_kernel(self.sampler, self.x, self.betas,
                                  self.steps, self.rng, thin=self.thin)
        self.x, self.lp = res.final_state
        return (res.chain, res.log_prob, res.acceptance_fraction.mean(1),
                np.asarray(res.swap_acceptance, dtype=np.float64))

    def job(self, run):
        chain, log_prob, acc, swap = self._phase()
        if run is not None:
            self.frames.append(chain)
            self.frames_lp.append(log_prob)
            self.cold_acc_steps += float(acc[0]) * self.steps
            self.window_steps += self.steps
            self.last_acc, self.last_swap = acc, swap
            run.count(evals=self.evals_per_step * self.steps,
                      steps=self.steps)

    def close(self):
        """After the window: keep on the host what the check reads, drop
        the program's state on the card."""
        self.x_end = self.x.cpu().numpy()
        self.lp_end = self.lp.cpu().numpy()
        del self.x, self.lp, self.sampler, self.sess

    def chain(self) -> np.ndarray:
        """The window's cold-rung frames (n_frames, W, D)."""
        return np.concatenate(self.frames)

    def check_rows(self):
        """``(rows, moves, swaps, stuck)``: the final state of every rung
        and ``check_frames`` cold (frame, walker) rows drawn from the
        seed; ``move_draws`` stretch proposals from each walker of the
        final state, judged against each rung's acceptance over the last
        phase (groups 0 .. K-1), and one from each cold row, judged
        against the cold rung's over the window (group K: rows spread
        over the window as its phases are); every rung's final state for
        the swaps, against each boundary's acceptance over the last
        phase; and the share of walkers (every rung) whose position at
        the window's close is the one it had at the window's start."""
        rng = np.random.default_rng([self.seed, 2])
        K, W, H = self.K, self.W, self.W // 2
        D = len(self.names)
        ch, lp = self.chain(), np.concatenate(self.frames_lp)
        n = int(self.traffic["check_frames"])
        f = rng.integers(0, ch.shape[0], n)
        w = rng.integers(0, W, n)
        x_end = self.x_end.reshape(-1, D)
        rows = Rows(theta=np.concatenate([x_end, ch[f, w]]),
                    lp=np.concatenate([self.lp_end.reshape(-1), lp[f, w]]))
        m = int(self.traffic["move_draws"])
        k = np.repeat(np.arange(K), W * m)
        i = np.tile(np.repeat(np.arange(W), m), K)
        y_end, z_end = stretch_proposals(rng, x_end[k * W + i], x_end,
                                         k * W + other_half(W, i), H,
                                         self.a)
        y_fr, z_fr = stretch_proposals(rng, ch[f, w], ch.reshape(-1, D),
                                       f * W + other_half(W, w), H, self.a)
        steps = max(self.window_steps, 1)
        moves = Moves(base=np.concatenate([k * W + i, K * W + np.arange(n)]),
                      theta=np.concatenate([y_end, y_fr]),
                      z=np.concatenate([z_end, z_fr]),
                      beta=np.concatenate([self.betas[k], np.ones(n)]),
                      group=np.concatenate([k, np.full(n, K)]),
                      program=np.append(self.last_acc,
                                        self.cold_acc_steps / steps),
                      decisions=np.append(np.full(K, float(self.steps * W)),
                                          float(steps * W)))
        swaps = (Swaps(rungs=np.arange(K * W).reshape(K, W),
                       db=self.betas[:-1] - self.betas[1:],
                       program=self.last_swap,
                       decisions=np.full(K - 1, float(self.steps * W)))
                 if K > 1 else None)
        stuck = float(np.mean(np.all(self.x_end == self.x0, axis=-1)))
        return rows, moves, swaps, stuck
