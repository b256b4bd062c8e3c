"""Traffic kind ``survey``: back-to-back surveys of ``clusters`` mock
clusters through ``survey.fit_survey(step_kernel=True)`` (``walkers``,
``burn_steps`` + ``steps``, ``thin``; over ``cards`` cards a mesh with a
``cluster`` axis), alternating between ``stacks`` mock stacks simulated
in set-up from the seed, truths spread as ``survey.mock_truths`` spreads
them.

The traffic's numbers besides: ``init_spread``; ``last_walkers``, the
walkers of every cluster's last frame and ``check_frames``, the
(frame, cluster, walker) rows of the whole chain that the check draws
from the seed in each job, the latter each with one stretch proposal."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import roofline
from benchmark.harness.jobs import (SEED_MAX, Moves, Rows, other_half,
                                    part, program_session,
                                    stretch_proposals, sync)
from benchmark.reference.data import (draw, predict, survey_truths,
                                      write_dataset)


class Jobs:
    kind = "survey"

    def __init__(self, config: dict, traffic: dict, seed: int, workdir,
                 device):
        t = traffic
        self.C, self.W, self.thin = t["clusters"], t["walkers"], t["thin"]
        self.burn, self.steps = t["burn_steps"], t["steps"]
        self.a = float(config["schedule"]["stretch_scale"])
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.cards = int(t["cards"])
        # one card a shard; off the card (tests) the shards share the CPU
        self.devices = ([torch.device("cuda", i) for i in range(self.cards)]
                        if self.device.type == "cuda"
                        else [self.device] * self.cards)
        self.workdir = workdir
        self.evals_per_step = self.C * self.W
        self.launch_steps = [self.burn, self.steps]
        self.timings, self.kept, self.stuck = [], [], []
        self.setup_parts = {}

    def setup(self):
        from joxsz_torch.models.multicluster import (stack_sz_data,
                                                     stack_xray_data)

        t = time.perf_counter()
        self.cfg_path, base, truth = write_dataset(self.config, self.workdir)
        self.names = list(base.params.thawed)
        self.shapes = roofline.model_shapes(base)
        self.truths = survey_truths(self.names, truth, self.C)
        rng = np.random.default_rng([self.seed, 3])
        flux, counts = predict(base, self.truths)
        self.data = [draw(base, flux, counts, rng)
                     for _ in range(int(self.traffic["stacks"]))]
        t = part(self.setup_parts, "data_s", t)
        self.sess = program_session(self.cfg_path, self.device, self.names)
        sz, xr = self.sess.model.sz_data, self.sess.model.xray_data
        self.stacks = []
        for fl, ct in self.data:
            self.stacks.append((
                stack_sz_data([dataclasses.replace(
                    sz, flux=torch.as_tensor(f, dtype=sz.flux.dtype,
                                             device=self.device))
                    for f in fl]),
                stack_xray_data([dataclasses.replace(
                    xr, counts_filled=torch.as_tensor(
                        c, dtype=xr.counts_filled.dtype, device=self.device))
                    for c in ct])))
        self.mesh = None
        if self.cards > 1:
            from joxsz_torch.parallel.mesh import make_mesh

            self.mesh = make_mesh(self.cards, ("cluster",),
                                  devices=self.devices)
        self.rng = np.random.default_rng([self.seed, 1])
        self.n_jobs = 0
        t = part(self.setup_parts, "session_s", t)
        # every shape of a job: the kernel route end to end, short
        self._fit(0, self.thin, self.thin)
        sync(self.devices)
        part(self.setup_parts, "warm_s", t)

    def _fit(self, stack: int, n_burn: int, n_steps: int):
        from joxsz_torch.survey import fit_survey

        sz, xr = self.stacks[stack]
        res = fit_survey(self.sess, sz, xr, self.truths, n_walkers=self.W,
                         n_burn=n_burn, n_steps=n_steps, thin=self.thin,
                         seed=int(self.rng.integers(0, SEED_MAX)),
                         init_spread=float(self.traffic["init_spread"]),
                         step_kernel=True, mesh=self.mesh)
        if res.timings is None:
            raise RuntimeError("the survey left the step-kernel route")
        return res

    def job(self, run):
        stack = self.n_jobs % len(self.stacks)
        t0 = time.perf_counter()
        res = self._fit(stack, self.burn, self.steps)
        wall = time.perf_counter() - t0
        self.n_jobs += 1
        self.timings.append(dict(res.timings, wall_s=wall))
        self.stuck.append(np.all(res.chain[0] == res.chain[-1], axis=-1))
        self._keep(stack, res)
        run.count(evals=self.evals_per_step * (self.burn + self.steps),
                  steps=self.burn + self.steps)

    def _keep(self, stack: int, res):
        """A sample drawn from the seed: ``last_walkers`` walkers of every
        cluster's last frame and ``check_frames`` (frame, cluster, walker)
        rows of the whole chain; a stretch proposal from each of the
        latter (spread over the sampling steps as the program's
        acceptance is) against the other half of its (frame, cluster)
        ensemble, and the program's acceptance over the job's sampling
        steps."""
        rng = np.random.default_rng([self.seed, 2, self.n_jobs])
        n_s, C, W, D = res.chain.shape
        k = int(self.traffic["last_walkers"])
        n = int(self.traffic["check_frames"])
        lw = rng.integers(0, W, (C, k))
        f = np.concatenate([np.full(C * k, n_s - 1), rng.integers(0, n_s, n)])
        c = np.concatenate([np.repeat(np.arange(C), k),
                            rng.integers(0, C, n)])
        w = np.concatenate([lw.reshape(-1), rng.integers(0, W, n)])
        r = slice(C * k, None)
        y, z = stretch_proposals(rng, res.chain[f[r], c[r], w[r]],
                                 res.chain.reshape(-1, D),
                                 (f[r] * C + c[r]) * W + other_half(W, w[r]),
                                 W // 2, self.a)
        fl, ct = self.data[stack]
        self.kept.append((Rows(theta=res.chain[f, c, w],
                               lp=res.log_prob[f, c, w],
                               flux=fl[c], counts=ct[c]),
                          y, z, float(np.mean(res.acceptance)),
                          float(C * W * self.steps)))

    def close(self):
        del self.stacks, self.sess, self.mesh

    def check_rows(self):
        """``(rows, moves, None, stuck)``: the rows and proposals kept
        from every job of the window, the program's acceptance pooled
        over the jobs, and the share of (cluster, walker) chains whose
        last frame is their first."""
        rows = Rows(*(np.concatenate([getattr(r, f) for r, *_ in self.kept])
                      for f in ("theta", "lp", "flux", "counts")))
        dec = np.array([d for *_, d in self.kept])
        acc = np.array([a for *_, a, _ in self.kept])
        # each job's proposals start from its last len(y) rows
        ends = np.cumsum([len(r.lp) for r, *_ in self.kept])
        base = np.concatenate([np.arange(e - len(y), e)
                               for e, (_, y, *_) in zip(ends, self.kept)])
        P = len(base)
        moves = Moves(base=base,
                      theta=np.concatenate([y for _, y, *_ in self.kept]),
                      z=np.concatenate([z for _, _, z, *_ in self.kept]),
                      beta=np.ones(P), group=np.zeros(P, dtype=int),
                      program=np.array([np.sum(acc * dec) / np.sum(dec)]),
                      decisions=np.array([np.sum(dec)]))
        return rows, moves, None, float(np.mean(np.concatenate(
            [s.reshape(-1) for s in self.stuck])))
