"""Multi-cluster survey fitting — CLI + library.

Torch counterpart of ``joxsz_tpu/survey.py``.  The reference fits one
cluster per process invocation; here C clusters fit at once: their data
containers stack with a leading cluster axis (``models/multicluster.py``)
and C independent walker ensembles advance together.  The production
route samples through the cluster-grid CUDA kernel (``ops.
multicluster_kernel``: one launch moves one half of every cluster's
ensemble against that cluster's own constants), with the walker
initialisation and the first log-posteriors through the joint-likelihood
kernel, once per cluster.  A stack outside the kernel's specialisation
(clusters whose grids differ: ``StackMismatch``) is sampled through the
plain batched ensembles on ``make_multicluster_log_like`` instead, with
a warning.  With a mesh that has a ``cluster`` axis (``--mesh N``) the
kernel route cuts the cluster grid into blocks of C / N clusters, one
per device (``parallel.kernel_sharded.make_sharded_multicluster_step``):
clusters are independent posteriors, so that is exact parallelism.

Two modes:

* ``--spec survey.json`` — one ``JoXSZConfig`` JSON per cluster::

      {"clusters": [{"name": "cl1", "config": "cl1.json"},
                    {"name": "cl2", "config": "cl2.json"}]}

  Clusters are grouped by model family (the thawed parameter vector) and
  stack signature (map geometry, every data tensor's shape, the priors),
  one batched fit runs per group — each group on the kernel instance of
  its family (``joint_ll.cuh`` picks the flagship body or the family
  body from the packed constants) — and the groups of one family merge
  back into one result in spec order.  A spec that mixes families gives
  one result per family: the summary's ``param_names`` is null, its
  ``families`` lists each family's vector, its clusters stay in spec
  order, and ``main`` returns the per-family bundles.  SZ-only clusters
  (configs without an X-ray part, or all clusters with ``--sz-only``)
  are a family of their own; unlike ``joxsz_tpu/survey.py``, which
  refuses it, a spec may mix them with joint clusters.

* ``--mock C`` — injection-recovery: C clusters simulated from the base
  configuration (``--config``) at distinct true parameters through the
  likelihood's own forward and noise models (``joxsz_torch.simulate``),
  fit jointly, recovered medians compared with the injected truths.

After the fit, ``--save-chains`` writes one chain per cluster beside
``--out`` (``<name>_chain.hdf5`` in the emcee layout, its ``.npz`` twin
where h5py is missing), and ``--population PARAM[:FAMILY]`` runs the
stage-2 hierarchical fit of one parameter over every cluster
(``sampling.population``; one model family only).

Several processes (``--multihost HOST:PORT --nprocs N --procid i``, one
per host or card group; ``--multihost-launch N`` starts N workers on this
machine) fit one survey as one ``torch.distributed`` job
(``parallel.multihost``): the cluster axis is cut over every process's
shards (its visible cards, or ``--cpu-devices K`` CPU shards), each
process fits and keeps its own clusters (``--save-chains`` writes them
where it runs), and only each cluster's medians, sds and acceptance are
gathered; process 0 prints the table and writes ``--out`` with the JAX
package's ``multihost`` block.  The seeds follow the global shard index,
so P processes of K shards give, cluster by cluster and bit for bit, what
``--mesh P*K`` gives in one process.

Usage:
    python -m joxsz_torch.survey --mock 4 --config cfg.json
    python -m joxsz_torch.survey --mock 2 --config cfg.json --cpu --quick
    python -m joxsz_torch.survey --mock 3 --config cfg.json --sz-only
    python -m joxsz_torch.survey --spec survey.json --walkers 256
    python -m joxsz_torch.survey --mock 4 --config cfg.json --mesh 4
    python -m joxsz_torch.survey --mock 8 --config cfg.json --population P_0
    python -m joxsz_torch.survey --spec survey.json --save-chains
    python -m joxsz_torch.survey --mock 4 --config cfg.json \
        --multihost-launch 2
    python -m joxsz_torch.survey --mock 2 --config cfg.json --cpu --quick \
        --multihost-launch 2 --cpu-devices 1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import time
import warnings

import numpy as np


@dataclasses.dataclass
class SurveyResult:
    cluster_names: list[str]
    param_names: list[str]
    chain: np.ndarray            # (n_saved, C, W, D) thinned post-burn
    log_prob: np.ndarray         # (n_saved, C, W)
    acceptance: np.ndarray       # (C, W)
    medians: np.ndarray          # (C, D)
    sds: np.ndarray              # (C, D)
    truths: np.ndarray | None = None    # (C, D) mock mode only
    timings: dict | None = None  # kernel route: its spans' seconds

    def flat_chain(self, c: int) -> np.ndarray:
        """((n_saved*W), D) posterior sample of cluster ``c``."""
        return self.chain[:, c].reshape(-1, self.chain.shape[-1])

    def to_dict(self) -> dict:
        out = {
            "param_names": self.param_names,
            "clusters": [
                {"name": self.cluster_names[c],
                 "acceptance": float(self.acceptance[c].mean()),
                 "median": dict(zip(self.param_names,
                                    self.medians[c].tolist())),
                 "sd": dict(zip(self.param_names, self.sds[c].tolist()))}
                for c in range(len(self.cluster_names))],
        }
        if self.truths is not None:
            for c, row in enumerate(out["clusters"]):
                row["truth"] = dict(zip(self.param_names,
                                        self.truths[c].tolist()))
        return out


def posterior_summary(chain):
    """Per-cluster medians and standard deviations of a cluster-major
    torch tensor ``chain`` (C, N, D), on the device that holds it: two
    (C, D) tensors of the chain's dtype.  The medians are ``np.median``'s
    of the same values, bit for bit: the middle order statistic for odd
    N, the mean of the two middle ones (in the chain's dtype) for even N,
    NaN where a column holds one.  The standard deviations are the
    population ones (ddof 0), two passes accumulated in float64."""
    import torch

    N = chain.shape[1]
    srt = torch.sort(chain, dim=1).values
    med = srt[:, N // 2]
    if N % 2 == 0:
        med = (srt[:, N // 2 - 1] + med) / 2
    med = torch.where(torch.isnan(srt[:, -1]), srt[:, -1], med)
    del srt
    x = chain.to(torch.float64, memory_format=torch.contiguous_format)
    dev = x - x.mean(dim=1, keepdim=True)
    del x
    sds = dev.square_().mean(dim=1).sqrt_().to(chain.dtype)
    return med, sds


def _host_summary(chain: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``posterior_summary`` of a host chain (n_saved, C, W, D), as
    numpy arrays."""
    import torch

    C, D = chain.shape[1], chain.shape[-1]
    flat = torch.from_numpy(chain).permute(1, 0, 2, 3).reshape(C, -1, D)
    return tuple(t.numpy() for t in posterior_summary(flat))


def fit_survey(session, sz_stack, xray_stack, centers, *,
               cluster_names=None, n_walkers=64, n_burn=500, n_steps=500,
               thin=5, seed=0, init_spread=0.05, truths=None,
               step_kernel=True, mesh=None) -> SurveyResult:
    """Fit C stacked clusters jointly; returns per-cluster posteriors.

    ``session``: a single-cluster ``FitSession`` providing the model,
    priors and device (every cluster thaws the same parameter vector);
    ``sz_stack`` / ``xray_stack``: stacked data (``models.multicluster.
    stack_*``); ``centers``: (C, D) per-cluster walker-init centers.

    ``step_kernel=True`` runs burn and sampling through the cluster-grid
    kernel; a stack outside its specialisation falls back to the plain
    batched ensembles with a warning (a mesh is then ignored, and the
    warning says so).  A kernel that fails to build or launch raises.
    ``mesh``: a mesh with a ``cluster`` axis that divides C shards the
    kernel route over cluster blocks.  The fit is the span ``survey.fit``,
    its summary (``posterior_summary``: medians, sds) ``survey.summary``
    (``utils.timing``); the kernel route takes it from the chain on the
    sampler's device before the fetch, and keeps its seconds in
    ``timings`` as ``summary_s``."""
    import torch

    from .models.multicluster import make_multicluster_log_like
    from .ops.joint_kernel import StackMismatch
    from .sampling.batched import batched_init, run_batched_ensembles
    from .sampling.kernel import fit_multicluster_kernel
    from .utils.timing import trace_annotation

    with trace_annotation("survey.fit"):
        model = session.model
        centers = np.atleast_2d(np.asarray(centers, dtype=np.float64))
        C, D = centers.shape
        names = list(model.params.thawed)
        if D != len(names):
            raise ValueError(f"centers have {D} columns but the model thaws "
                             f"{len(names)} parameters {names}")

        out = None
        if step_kernel:
            try:
                out = fit_multicluster_kernel(
                    session, sz_stack, xray_stack, centers,
                    n_walkers=n_walkers, n_burn=n_burn, n_steps=n_steps,
                    thin=thin, seed=seed, init_spread=init_spread, mesh=mesh)
            except StackMismatch as e:
                warnings.warn("configuration outside the multicluster "
                              f"step-kernel specialisation ({e}); falling "
                              "back to the plain batched ensemble sampler"
                              + (" (the 'cluster' mesh request is IGNORED "
                                 "on this path)" if mesh is not None
                                 else ""), stacklevel=2)
        timings = None
        if out is not None:
            chain, lp_chain, acc, timings, (medians, sds) = out
        else:
            dev = session.device
            batched_ll = make_multicluster_log_like(model, sz_stack,
                                                    xray_stack)
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
            with torch.no_grad():
                p0 = batched_init(batched_ll, centers, n_walkers, gen,
                                  device=dev, dtype=sz_stack.L.dtype,
                                  spread=init_spread)
                chain, lp_chain, acc, _ = run_batched_ensembles(
                    batched_ll, p0, n_burn, n_steps, gen, thin=thin)
            with trace_annotation("survey.summary"):
                medians, sds = _host_summary(chain)
        return SurveyResult(
            cluster_names=(list(cluster_names) if cluster_names is not None
                           else [f"cluster{c}" for c in range(C)]),
            param_names=names, chain=chain, log_prob=lp_chain,
            acceptance=acc, medians=medians, sds=sds,
            truths=None if truths is None else np.asarray(truths),
            timings=timings)


def _tensor_shapes(data) -> tuple:
    import torch

    if data is None:
        return ("none",)
    out = []
    for f in dataclasses.fields(data):
        v = getattr(data, f.name)
        if torch.is_tensor(v):
            out.append(tuple(v.shape))
        elif dataclasses.is_dataclass(v):
            out.extend(_tensor_shapes(v))
    return tuple(out)


def _stack_signature(sess) -> tuple:
    """Hashable stack signature of one cluster: the static fields (sep,
    calc_integ) plus the shape of every SZ/X-ray data tensor — the
    rectangular-stacking requirement of ``models.multicluster.stack_*`` —
    plus the model fingerprint.  Clusters sharing a signature batch into
    one fit; value-level differences inside a group (other redshifts on
    equal grids) are for the kernel's ``StackMismatch`` to decline."""
    sz = sess.model.sz_data
    return ((int(sz.sep), bool(sz.calc_integ)) + _tensor_shapes(sz)
            + _tensor_shapes(sess.model.xray_data)
            + _model_fingerprint(sess))


def _model_fingerprint(sess) -> tuple:
    """Model-level settings a batched group shares from its
    representative session: the prior boxes and Gaussians, the frozen
    parameter values, the physicality-veto flag and, for knot pressure,
    the knots' radii.  Two clusters with equal shapes but other priors
    must not batch: the group fit would apply the first cluster's model
    to all."""
    p = sess.params
    frozen = tuple((n, float(p[n].val)) for n in p.names if p[n].frozen)
    knots = getattr(sess.model.pressure, "knots_logr", None)
    return (bool(sess.model.exclude_unphysical_mass), frozen,
            () if knots is None else tuple(np.asarray(knots, float)),
            tuple(np.asarray(p.lo, float)), tuple(np.asarray(p.hi, float)),
            tuple(bool(g) for g in np.asarray(p.is_gauss)),
            tuple(np.asarray(p.mu, float)),
            tuple(np.asarray(p.sigma, float)))


def _merge_survey_results(results: list[SurveyResult],
                          orders: list[list[int]], C: int) -> SurveyResult:
    """Merge per-group results into one in spec order.  Chains
    concatenate along the cluster axis (every group runs the same
    schedule); per-group kernel timings are kept as a list."""
    n_saved, _, W, D = results[0].chain.shape
    names = [None] * C
    chain = np.empty((n_saved, C, W, D), results[0].chain.dtype)
    log_prob = np.empty((n_saved, C, W), results[0].log_prob.dtype)
    acceptance = np.empty((C, W), results[0].acceptance.dtype)
    medians = np.empty((C, D))
    sds = np.empty((C, D))
    truths = (np.full((C, D), np.nan)
              if any(r.truths is not None for r in results) else None)
    for res, idxs in zip(results, orders):
        if res.param_names != results[0].param_names:
            raise ValueError("survey groups thaw different parameters")
        if res.chain.shape[0] != n_saved or res.chain.shape[2] != W:
            raise ValueError("survey groups ran different schedules")
        chain[:, idxs] = res.chain
        log_prob[:, idxs] = res.log_prob
        acceptance[idxs] = res.acceptance
        medians[idxs] = res.medians
        sds[idxs] = res.sds
        for i, c in enumerate(idxs):
            names[c] = res.cluster_names[i]
            if truths is not None and res.truths is not None:
                truths[c] = res.truths[i]       # a group without: NaN rows
    timings = None
    if any(r.timings is not None for r in results):
        timings = {"groups": [r.timings for r in results]}
    return SurveyResult(
        cluster_names=names, param_names=results[0].param_names,
        chain=chain, log_prob=log_prob, acceptance=acceptance,
        medians=medians, sds=sds, truths=truths, timings=timings)


def _build_spec_survey(spec_path, args, device):
    """--spec: one session per per-cluster config (SZ-only with
    ``args.sz_only``); clusters grouped by (thawed vector, stack
    signature), data stacked per group.  Returns a list of groups
    ``(session, sz_stack, xray_stack, centers, names, truths,
    orig_indices)``; ``xray_stack`` is None for an SZ-only group."""
    from .build import build_session
    from .config import JoXSZConfig
    from .models.multicluster import stack_sz_data, stack_xray_data
    from .sampling.mle import find_mle

    spec = json.loads(pathlib.Path(spec_path).read_text())
    entries = spec.get("clusters")
    if not entries:
        raise SystemExit(f"{spec_path}: no 'clusters' list")
    names, sessions = [], []
    for e in entries:
        cfgp = pathlib.Path(e["config"])
        if not cfgp.is_absolute():
            cfgp = pathlib.Path(spec_path).parent / cfgp
        cfg = JoXSZConfig.from_json(cfgp.read_text())
        names.append(e.get("name", cfg.name))
        sessions.append(build_session(
            cfg, device=device, sz_only=getattr(args, "sz_only", False)))

    # per-cluster centres as a list: families thaw vectors of other
    # lengths, so each group stacks its own below
    centers = [np.asarray(s.params.thawed_values()) for s in sessions]
    if getattr(args, "mle", False):
        for c, s in enumerate(sessions):
            theta, ll = find_mle(s.model, centers[c], s.params.lo,
                                 s.params.hi, device=s.device)
            print(f"  {names[c]}: MLE log-like {ll:.2f}")
            centers[c] = np.asarray(theta)

    by_sig: dict[tuple, list[int]] = {}
    for i, s in enumerate(sessions):
        by_sig.setdefault(
            (tuple(s.params.thawed), _stack_signature(s)), []).append(i)
    groups = []
    for idxs in by_sig.values():
        sz_only = sessions[idxs[0]].model.xray_data is None
        groups.append((
            sessions[idxs[0]],
            stack_sz_data([sessions[i].model.sz_data for i in idxs]),
            None if sz_only else stack_xray_data(
                [sessions[i].model.xray_data for i in idxs]),
            np.stack([centers[i] for i in idxs]),
            [names[i] for i in idxs], None, idxs))
    return groups


def mock_truths(params, C: int) -> np.ndarray:
    """(C, D) injected truths of a mock survey: the parameter set's values
    with the pressure spread by x0.7..1.3 (``P_0``; for knot pressure every
    knot value by log10 of the factor) and ``\\beta`` by -0.03..0.03."""
    names = list(params.thawed)
    truths = np.tile(np.asarray(params.thawed_values()), (C, 1))
    scale = np.linspace(0.7, 1.3, C)
    if "P_0" in names:
        truths[:, names.index("P_0")] *= scale
    else:
        knots = [i for i, n in enumerate(names) if n.startswith("logP_")]
        truths[:, knots] += np.log10(scale)[:, None]
    if "\\beta" in names:
        truths[:, names.index("\\beta")] += np.linspace(-0.03, 0.03, C)
    return truths


def _build_mock_survey(C, args, device):
    """--mock C: simulate C clusters from the base configuration (SZ-only
    with ``args.sz_only``) at ``mock_truths``."""
    from .build import build_session
    from .config import JoXSZConfig
    from .simulate import simulate_survey

    if args.config:
        cfg = JoXSZConfig.from_json(pathlib.Path(args.config).read_text())
    elif args.data_dir:
        cfg = JoXSZConfig.cl1226(args.data_dir)
    else:
        raise SystemExit("--mock needs a base configuration: pass --config "
                         "(or --data-dir with the CL J1226 data files)")
    sess = build_session(cfg, device=device, sz_only=args.sz_only)
    truths = mock_truths(sess.params, C)
    survey = simulate_survey(sess.model, truths,
                             np.random.default_rng(args.seed))
    return (sess, survey.sz_stack, survey.xray_stack, truths,
            [f"mock{c}" for c in range(C)], truths)


def chain_suffix() -> str:
    """The chains' file suffix here: ``.hdf5`` where h5py is importable,
    else the ``.npz`` twin (``io.checkpoint.save_chain``)."""
    from .io.checkpoint import has_h5py

    return ".hdf5" if has_h5py() else ".npz"


def _merge_by_family(results: list[SurveyResult], orders: list[list[int]]):
    """The groups' results merged per model family (its thawed vector):
    ``[(result, spec indices in its row order)]`` in the order families
    first appear.  Groups of one family merge as
    ``_merge_survey_results`` does; families' chains have other widths,
    so they stay apart (``joxsz_tpu/survey.py:954-972``)."""
    byfam: dict[tuple, list[int]] = {}
    for gi, r in enumerate(results):
        byfam.setdefault(tuple(r.param_names), []).append(gi)
    bundles = []
    for gis in byfam.values():
        if len(gis) == 1:
            bundles.append((results[gis[0]], list(orders[gis[0]])))
            continue
        specs = sorted(i for gi in gis for i in orders[gi])
        pos = {sp: k for k, sp in enumerate(specs)}
        bundles.append((_merge_survey_results(
            [results[gi] for gi in gis],
            [[pos[i] for i in orders[gi]] for gi in gis], len(specs)),
            specs))
    return bundles


# seconds the workers of --multihost-launch may take, all told
MULTIHOST_DEADLINE_S = 1800


def _multihost_kernel_fit(args, sess, sz_stack, xray_stack, centers, mesh,
                          init_spread: float = 0.05) -> dict:
    """The kernel route across processes (``sampling.kernel.
    fit_multicluster_kernel`` over a mesh of n shards, of which this
    process runs its own): the same start on every process, burn on the
    seeds ``(2 seed + 1) n + s`` and sampling on ``(2 seed + 2) n + s``
    for shard s, acceptance reset after the burn.  Returns this process's
    clusters: ``cluster_range`` [c0, c1), ``chain`` (n_saved, c1 - c0, W,
    D), ``chain_log_prob``, ``acceptance_fraction`` (c1 - c0, W).  Raises
    ``StackMismatch`` outside the kernel's specialisation."""
    import torch

    from .parallel.multihost import (local_block,
                                     make_multihost_multicluster_step,
                                     place_multicluster_consts)
    from .sampling.kernel import multicluster_start

    stack, x, lp, acc = multicluster_start(sess, sz_stack, xray_stack,
                                           centers, args.walkers, args.seed,
                                           init_spread)
    n = mesh.shape["cluster"]
    consts = place_multicluster_consts(stack, mesh)

    def seeds(base):
        return [base * n + d for d in range(n)]

    if args.burn:
        x, lp, _ = make_multihost_multicluster_step(
            stack, mesh, args.burn, consts_global=consts)(
                x, lp, acc, seeds(2 * args.seed + 1))
    x, lp, acc, chain, chain_lp = make_multihost_multicluster_step(
        stack, mesh, args.steps, thin=args.thin, consts_global=consts)(
            x, lp, torch.zeros_like(acc), seeds(2 * args.seed + 2))
    c0, c1, chain = local_block(chain)
    _, _, chain_lp = local_block(chain_lp)
    # the acceptance divided on the device, as the one-process route does
    # (a card divides by a scalar through its reciprocal)
    acc = dataclasses.replace(acc, shards=[
        (s, st, t / float(args.steps)) for s, st, t in acc.shards])
    return {"cluster_range": (c0, c1),
            "chain": np.transpose(chain, (1, 0, 2, 3)),
            "chain_log_prob": np.transpose(chain_lp, (1, 0, 2)),
            "acceptance_fraction": local_block(acc)[2]}


def _multihost_plain_fit(args, sess, sz_stack, xray_stack, centers, mesh,
                         device, init_spread: float = 0.05) -> dict:
    """The plain batched ensembles across processes, for a stack outside
    the kernel's specialisation (``parallel.multihost.
    run_multihost_multi_cluster``): the same start on every process, this
    process's cluster blocks on likelihoods of their own data."""
    import torch

    from .models.multicluster import (make_multicluster_log_like,
                                      stack_sz_data, stack_xray_data,
                                      unstack)
    from .parallel.mesh import is_local
    from .parallel.multihost import run_multihost_multi_cluster
    from .sampling.batched import batched_init

    C = centers.shape[0]
    devices = mesh.axis_devices("cluster")
    c_loc = C // len(devices)

    def block_ll(c0, c1):
        take = lambda st: None if st is None else [   # noqa: E731
            unstack(st, c) for c in range(c0, c1)]
        szs, xrs = take(sz_stack), take(xray_stack)
        return make_multicluster_log_like(
            sess.model, stack_sz_data(szs),
            None if xrs is None else stack_xray_data(xrs))

    fns = [block_ll(s * c_loc, (s + 1) * c_loc) if is_local(d) else None
           for s, d in enumerate(devices)]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(args.seed))
    with torch.no_grad():
        p0 = batched_init(make_multicluster_log_like(
            sess.model, sz_stack, xray_stack), centers, args.walkers, gen,
            device=device, dtype=sz_stack.L.dtype, spread=init_spread)
        return run_multihost_multi_cluster(
            fns, p0, args.steps, gen, mesh, thin=args.thin,
            n_burn=args.burn, record=True)


def _run_multihost_survey(args, group, info, device, suffix):
    """Worker body of the multi-process survey
    (``joxsz_tpu/survey.py::_run_multihost_survey``): one fit over the
    global 'cluster' mesh, each process keeping its own clusters (chains
    written where it runs), then every cluster's median, sd and
    acceptance gathered so that process 0 prints and writes the whole
    survey.  Returns ``{"cluster_range", "medians", "sds",
    "acceptance"}``."""
    import torch
    import torch.distributed as dist

    from .ops.joint_kernel import StackMismatch
    from .ops.multicluster_kernel import stretch_steps_multicluster
    from .parallel.multihost import finalize, global_mesh

    sess, sz_stack, xray_stack, centers, names, truths, _ = group
    C, D = centers.shape
    mesh = global_mesh(axis_names=("cluster",))
    n_dev = info.global_devices
    pid = info.process_id
    print(f"process {pid}/{info.num_processes}: global mesh of {n_dev} "
          "devices")
    if device.type == "cuda":
        vis = os.environ.get("CUDA_VISIBLE_DEVICES", "all")
        print(f"process {pid}: cards {vis} ({torch.cuda.device_count()} "
              f"visible, {torch.cuda.get_device_name(device)})")
    if C % n_dev:
        raise SystemExit(f"clusters ({C}) must divide over the job's "
                         f"{n_dev} devices")
    n0 = stretch_steps_multicluster.launches
    t0 = time.time()
    try:
        out = _multihost_kernel_fit(args, sess, sz_stack, xray_stack,
                                    centers, mesh)
        route = "kernel route (cluster-grid kernel)"
    except StackMismatch as e:
        warnings.warn("configuration outside the multicluster step-kernel "
                      f"specialisation ({e}); falling back to the plain "
                      "batched ensemble sampler", stacklevel=2)
        out = _multihost_plain_fit(args, sess, sz_stack, xray_stack,
                                   centers, mesh, device)
        route = "plain batched ensembles"
    wall = time.time() - t0
    c0, c1 = out["cluster_range"]
    acc = out["acceptance_fraction"]
    acc_loc = np.array([acc[i].mean() for i in range(c1 - c0)])
    evals = C * args.walkers * (args.burn + args.steps)
    print(f"process {pid}: clusters [{c0}, {c1}) sampled in {wall:.1f}s "
          f"({evals / wall:.0f} global evals/s); acceptance "
          f"{acc_loc.mean():.3f}; {route}, "
          f"{stretch_steps_multicluster.launches - n0} launches of the "
          "cluster-grid kernel")

    # local (n_saved, C_loc, W, D) -> per-cluster medians and sds
    chain = out["chain"]
    med_loc, sd_loc = _host_summary(chain)
    pnames = list(sess.params.thawed)
    if suffix is not None:
        from .io.checkpoint import save_chain

        outdir = pathlib.Path(args.out).parent
        for i, c in enumerate(range(c0, c1)):
            p = outdir / f"{names[c]}_chain{suffix}"
            save_chain(str(p), chain[:, i], out["chain_log_prob"][:, i],
                       acc[i], pnames, nburn=args.burn, nthin=args.thin)
            print(f"process {pid}: written {p}")

    # the summaries cross processes; blocks are placed by their gathered
    # [c0, c1) ranges, not by process order
    parts = [None] * info.num_processes
    dist.all_gather_object(parts, ((c0, c1), med_loc, sd_loc, acc_loc))
    ranges = np.array([p[0] for p in parts], np.int64)
    medians = np.empty((C, D))
    sds = np.empty((C, D))
    acceptance = np.empty(C)
    covered = np.zeros(C, bool)
    for (lo, hi), m, sd, a in parts:
        medians[lo:hi], sds[lo:hi], acceptance[lo:hi] = m, sd, a
        covered[lo:hi] = True
    finalize()
    if not covered.all():
        raise SystemExit(f"cluster coverage gap: {np.flatnonzero(~covered)}")

    if info.is_coordinator:
        for c in range(C):
            print(f"--- {names[c]} ---")
            for i, n in enumerate(pnames):
                line = (f"  {n:>18} | {medians[c, i]:9.3f} "
                        f"+- {sds[c, i]:7.3f}")
                if truths is not None:
                    pull = ((medians[c, i] - truths[c, i])
                            / max(sds[c, i], 1e-12))
                    line += (f"   truth {truths[c, i]:9.3f} "
                             f"(pull {pull:+.1f} sd)")
                print(line)
        summary = {
            "param_names": pnames,
            "multihost": {"num_processes": info.num_processes,
                          "global_devices": n_dev,
                          "ranges": ranges.tolist()},
            "clusters": [
                {"name": names[c],
                 "acceptance": float(acceptance[c]),
                 "median": dict(zip(pnames, medians[c].tolist())),
                 "sd": dict(zip(pnames, sds[c].tolist())),
                 **({"truth": dict(zip(pnames, truths[c].tolist()))}
                    if truths is not None else {})}
                for c in range(C)],
        }
        outp = pathlib.Path(args.out)
        outp.write_text(json.dumps(summary, indent=2))
        print(f"written {outp}")
    return {"cluster_range": (c0, c1), "medians": medians, "sds": sds,
            "acceptance": acceptance}


def _strip_launch(argv: list) -> list:
    """``argv`` without its ``--multihost-launch N``."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--multihost-launch":
            skip = True
        elif not a.startswith("--multihost-launch="):
            out.append(a)
    return out


def _worker_cards(n: int) -> list:
    """``CUDA_VISIBLE_DEVICES`` of each of n workers on this machine's M
    visible cards: M // n cards each where M >= n, else card i mod M for
    worker i (workers share cards)."""
    import torch

    m = torch.cuda.device_count()
    if m == 0:
        raise SystemExit("--multihost-launch: no CUDA card visible (pass "
                         "--cpu to run the workers on the CPU)")
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ([v for v in vis.split(",") if v.strip()] if vis
           else [str(i) for i in range(m)])[:m]
    if m >= n:
        per = m // n
        return [",".join(ids[i * per:(i + 1) * per]) for i in range(n)]
    return [ids[i % m] for i in range(n)]


def _multihost_launch(args, argv: list):
    """Start N worker processes on this machine running this survey as
    one job (``joxsz_tpu/survey.py::_multihost_launch``): a free local
    port as the rendezvous, each worker its own log, polled so that one
    failing (or the deadline passing) ends its peers at once; then worker
    0's log, and the others' status lines."""
    import socket
    import subprocess
    import tempfile

    if args.population:
        raise SystemExit(
            "--population needs every cluster's chain in one process; "
            "run it offline from --save-chains output")
    n = args.multihost_launch
    if n < 1:
        raise SystemExit(f"--multihost-launch needs N >= 1, got {n}")
    cards = None if args.cpu else _worker_cards(n)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    base = ([sys.executable, "-u", "-m", "joxsz_torch.survey"]
            + _strip_launch(argv)
            + ["--multihost", f"127.0.0.1:{port}", "--nprocs", str(n)])
    if args.cpu and args.cpu_devices is None:
        base += ["--cpu-devices", "1"]
    # the workers import this package wherever they start
    root = str(pathlib.Path(__file__).resolve().parents[1])
    path = os.environ.get("PYTHONPATH")
    with tempfile.TemporaryDirectory(prefix="joxsz_mh_") as td:
        td = pathlib.Path(td)
        procs = []
        try:
            for i in range(n):
                env = dict(os.environ,
                           PYTHONPATH=root + (os.pathsep + path if path
                                              else ""))
                if cards is not None:
                    env["CUDA_VISIBLE_DEVICES"] = cards[i]
                    print(f"worker {i}: CUDA_VISIBLE_DEVICES={cards[i]}")
                log = open(td / f"w{i}.log", "w")
                procs.append((subprocess.Popen(
                    base + ["--procid", str(i)], stdout=log,
                    stderr=subprocess.STDOUT, env=env), log))
            deadline = time.monotonic() + MULTIHOST_DEADLINE_S
            fail = False
            live = dict(enumerate(procs))
            while live and not fail:
                for i in list(live):
                    rc = live[i][0].poll()
                    if rc is None:
                        continue
                    del live[i]
                    if rc:
                        fail = True
                        print(f"worker {i} FAILED (rc={rc}):")
                        print((td / f"w{i}.log").read_text()[-3000:])
                if live and not fail and time.monotonic() > deadline:
                    fail = True
                    print(f"TIMEOUT: workers {sorted(live)} still running "
                          f"after {MULTIHOST_DEADLINE_S}s")
                if live and not fail:
                    time.sleep(0.25)
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.terminate()
                    try:
                        p.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
                log.close()
        if fail:
            raise SystemExit(1)
        # the coordinator's output (summary table, files), then the
        # others' status lines
        print((td / "w0.log").read_text(), end="")
        for i in range(1, n):
            for line in (td / f"w{i}.log").read_text().splitlines():
                if line.startswith("process "):
                    print(line)
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="JoXSZ multi-cluster survey fit (PyTorch/CUDA)")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--spec", metavar="SURVEY_JSON",
                   help="survey spec: {'clusters': [{'name', 'config'}]}")
    g.add_argument("--mock", type=int, metavar="C",
                   help="injection-recovery demo with C clusters simulated "
                        "from the base configuration")
    ap.add_argument("--config", help="base JSON config of --mock")
    ap.add_argument("--data-dir", help="CL J1226 data directory (base of "
                    "--mock when no --config is given)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--sz-only", action="store_true",
                    help="fit the SZ data alone (the X-ray parts of the "
                         "configurations are ignored)")
    ap.add_argument("--quick", action="store_true",
                    help="short schedule for smoke testing")
    ap.add_argument("--walkers", type=int, default=64)
    ap.add_argument("--burn", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--thin", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", type=int, metavar="N",
                    help="shard the cluster grid of the kernel route over "
                         "an N-device 'cluster' mesh: one block of C/N "
                         "clusters per device; N must divide C")
    ap.add_argument("--mle", action="store_true",
                    help="per-cluster MLE warm starts (spec mode)")
    ap.add_argument("--population", metavar="PARAM[:FAMILY]",
                    help="stage-2 hierarchical population inference on "
                         "one fitted parameter (family 'lognormal' "
                         "[default] or 'gaussian'): posterior of the "
                         "population mean and intrinsic scatter "
                         "(sampling/population.py); e.g. 'P_0' or "
                         "'\\beta:gaussian'")
    ap.add_argument("--out", default="survey_summary.json")
    ap.add_argument("--save-chains", action="store_true",
                    help="write one chain per cluster beside --out "
                         "(<name>_chain.hdf5 in the emcee layout, or its "
                         ".npz twin without h5py; usable with run.py "
                         "--postprocess)")
    mh = ap.add_argument_group(
        "multi-host", "one torch.distributed job spanning processes/hosts: "
        "the cluster axis shards over every process's devices; chains "
        "never cross hosts (parallel/multihost.py). Run one process per "
        "host with --multihost/--nprocs/--procid; --multihost-launch N "
        "spawns N local workers (single-host mode: each its own cards, or "
        "cards shared where there are fewer than N; with --cpu, CPU "
        "workers).")
    mh.add_argument("--multihost", metavar="HOST:PORT",
                    help="join the job at this coordinator address")
    mh.add_argument("--nprocs", type=int, default=None,
                    help="total processes in the job")
    mh.add_argument("--procid", type=int, default=None,
                    help="this process's id (0..nprocs-1)")
    mh.add_argument("--cpu-devices", type=int, default=None,
                    help="CPU shards per process (test mode; implies "
                         "--cpu; omit on cards)")
    mh.add_argument("--multihost-launch", type=int, metavar="N",
                    help="spawn N local worker processes running this "
                         "same survey as one distributed job "
                         "(--cpu-devices defaults to 1 with --cpu)")
    args = ap.parse_args(argv)
    if args.cpu_devices is not None:
        args.cpu = True

    if args.multihost_launch:
        return _multihost_launch(args, list(sys.argv[1:] if argv is None
                                            else argv))

    mh_info = None
    if args.multihost:
        if args.nprocs is None or args.procid is None:
            raise SystemExit("--multihost needs --nprocs and --procid")
        if args.population:
            raise SystemExit(
                "--population needs every cluster's chain in one "
                "process; run it offline from --save-chains output "
                "(chains never cross hosts in multihost mode)")

    from .device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    if args.multihost:
        from .parallel.multihost import initialize

        mh_info = initialize(args.multihost, args.nprocs, args.procid,
                             cpu_devices=(args.cpu_devices or 1) if args.cpu
                             else None)
    if args.quick:
        args.walkers, args.burn, args.steps, args.thin = 32, 150, 150, 5
    # the chains' format is settled before the fit, so a missing writer
    # cannot lose a finished survey
    suffix = chain_suffix() if args.save_chains else None

    t0 = time.time()
    if args.spec:
        groups = _build_spec_survey(args.spec, args, device)
    else:
        sess, sz_stack, xray_stack, centers, names, truths = \
            _build_mock_survey(args.mock, args, device)
        groups = [(sess, sz_stack, xray_stack, centers, names, truths,
                   list(range(len(names))))]
    C = sum(len(g[6]) for g in groups)
    names = [None] * C
    for g in groups:
        for i, c in enumerate(g[6]):
            names[c] = g[4][i]
    n_xray = sum(len(g[6]) for g in groups if g[2] is not None)
    probes = ("joint SZ+X" if n_xray == C else "SZ-only" if n_xray == 0
              else f"joint SZ+X ({n_xray}) and SZ-only ({C - n_xray})")
    print(f"survey of {C} clusters built in {time.time() - t0:.1f}s "
          f"({probes}; {len(groups)} stack group(s); device {device})")

    if mh_info is not None:
        if len(groups) > 1:
            raise SystemExit(
                "--multihost needs a homogeneous survey (one stack "
                f"group; this spec has {len(groups)}): split the spec "
                "by instrument configuration for multihost runs")
        return _run_multihost_survey(args, groups[0], mh_info, device,
                                     suffix)

    mesh = None
    if args.mesh:
        import torch

        from .parallel import make_mesh

        n_have = args.mesh if args.cpu else torch.cuda.device_count()
        if args.mesh > n_have:
            raise SystemExit(f"--mesh {args.mesh} needs {args.mesh} "
                             f"devices, have {n_have}")
        mesh = make_mesh(args.mesh, axis_names=("cluster",),
                         devices=[device] * args.mesh if args.cpu else None)

    t0 = time.time()
    results, orders = [], []
    for gi, (gsess, sz_stack, xray_stack, centers, gnames, truths,
             idxs) in enumerate(groups):
        if len(groups) > 1:
            print(f"group {gi + 1}/{len(groups)}: {len(idxs)} cluster(s) "
                  f"{gnames}")
        # a spec can split into groups whose cluster count does not divide
        # over the mesh: those run on one device, with a note
        gmesh = mesh
        if mesh is not None and len(idxs) % args.mesh:
            print(f"  note: {len(idxs)} cluster(s) don't divide over the "
                  f"{args.mesh}-device mesh — this group runs on one device")
            gmesh = None
        results.append(fit_survey(
            gsess, sz_stack, xray_stack, centers, cluster_names=gnames,
            n_walkers=args.walkers, n_burn=args.burn, n_steps=args.steps,
            thin=args.thin, seed=args.seed + gi, truths=truths, mesh=gmesh))
        orders.append(idxs)
    bundles = _merge_by_family(results, orders)
    single_family = len(bundles) == 1
    res = bundles[0][0]
    # cluster c of the spec -> (its family's result, its row there)
    where = {sp: (fres, local) for fres, specs in bundles
             for local, sp in enumerate(specs)}

    evals = C * args.walkers * (args.burn + args.steps)
    wall = time.time() - t0
    acc = np.array([where[c][0].acceptance[where[c][1]].mean()
                    for c in range(C)])
    print(f"fit {C} x {args.walkers} walkers x {args.burn}+{args.steps} "
          f"steps in {wall:.1f}s ({evals / wall:.0f} evals/s); acceptance "
          f"{np.round(acc, 3)}")
    for r, idxs in zip(results, orders):
        if r.timings is not None:
            # this group's evals over its own wall time
            ts, tk = r.timings["setup_s"], r.timings["sampling_s"]
            evals_g = len(idxs) * args.walkers * (args.burn + args.steps)
            print(f"  kernel route ({len(r.param_names)} parameters): "
                  f"{ts:.1f}s setup (constants, init) + {tk:.1f}s "
                  f"burn+sampling ({evals_g / tk:.0f} evals/s)")

    for c in range(C):
        fres, local = where[c]
        print(f"--- {names[c]} ---")
        for i, n in enumerate(fres.param_names):
            line = (f"  {n:>18} | {fres.medians[local, i]:9.3f} "
                    f"+- {fres.sds[local, i]:7.3f}")
            if fres.truths is not None:
                pull = ((fres.medians[local, i] - fres.truths[local, i])
                        / max(fres.sds[local, i], 1e-12))
                line += (f"   truth {fres.truths[local, i]:9.3f} "
                         f"(pull {pull:+.1f} sd)")
            print(line)

    if single_family:
        summary = res.to_dict()
    else:
        # rows in spec order, each with its own family's names; the flat
        # 'param_names' means nothing across families
        clusters = [None] * C
        fam_names = []
        for fres, specs in bundles:
            d = fres.to_dict()
            fam_names.append(d["param_names"])
            for local, sp in enumerate(specs):
                clusters[sp] = d["clusters"][local]
        summary = {"param_names": None, "families": fam_names,
                   "clusters": clusters}
    if args.population:
        if not single_family:
            raise SystemExit(
                "--population needs one shared model family (the "
                "hierarchy pools ONE parameter across clusters); this "
                f"spec mixes {len(bundles)} families — split the spec by "
                "family")
        from .sampling.population import population_from_survey

        pspec = args.population.split(":")
        family = pspec[1] if len(pspec) > 1 else "lognormal"
        pres = population_from_survey(res, groups[0][0].params, pspec[0],
                                      family=family, seed=args.seed,
                                      device=device)
        mu_label = ("ln " if family == "lognormal" else "") + pspec[0]
        print(f"population ({family}): <{mu_label}> = {pres.mu:.4f} +- "
              f"{pres.mu_sd:.4f}, intrinsic scatter sigma = "
              f"{pres.sigma:.4f} +- {pres.sigma_sd:.4f} (min weight n_eff "
              f"{pres.n_eff_weights.min():.0f} of {pres.n_samples} stage-1 "
              "draws/cluster)")
        summary["population"] = pres.to_dict()

    out = pathlib.Path(args.out)
    out.write_text(json.dumps(summary, indent=2))
    print(f"written {out}")

    if suffix is not None:
        from .io.checkpoint import save_chain

        for c in range(C):
            fres, local = where[c]
            p = out.parent / f"{names[c]}_chain{suffix}"
            save_chain(str(p), fres.chain[:, local], fres.log_prob[:, local],
                       fres.acceptance[local], fres.param_names,
                       nburn=args.burn, nthin=args.thin)
            print(f"written {p}")
    # a mixed-family survey has no single rectangular result
    return res if single_family else bundles


if __name__ == "__main__":
    main()
