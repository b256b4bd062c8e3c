"""The general traffic generator.  A traffic file's ``kind`` names the
generator of its jobs, ``traffic/<kind>.py``, found by name: its class
``Jobs(config, traffic, seed, workdir, device)`` drives the entry of the
program that the window times, sized by the traffic's numbers and the
configuration's.  The same seed gives the same data, the same start and
the same sequence of Philox seeds.

A ``Jobs`` has ``setup()``, ``job(run)`` (one job of the window, counted
with ``run.count``), ``close()`` (after the window: keep on the host what
the check reads, free the program's state) and ``check_rows()`` (the
rows, stretch proposals and swaps the reference judges, see
``harness.check``), and the attributes ``devices``, ``device``,
``evals_per_step``, ``launch_steps``, ``setup_parts``, ``shapes`` and
``cfg_path``.  This module holds what the kinds share."""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
import time

import numpy as np
import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
SEED_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class Rows:
    """Rows the reference re-evaluates: thetas (B, D), the program's
    log-posteriors (B,) and, for a survey, each row's cluster data."""

    theta: np.ndarray
    lp: np.ndarray
    flux: np.ndarray | None = None       # (B, n_sz)
    counts: np.ndarray | None = None     # (B, n_band, n_ann)


@dataclasses.dataclass
class Moves:
    """Stretch proposals the reference judges: checked row ``base[i]``
    moved to ``theta[i]`` by the factor ``z[i]`` at inverse temperature
    ``beta[i]``, in group ``group[i]`` (a rung); and, for each group, the
    share of its moves that the program accepted over the window and the
    number of decisions behind that share."""

    base: np.ndarray         # (P,) int, rows of ``Rows``
    theta: np.ndarray        # (P, D)
    z: np.ndarray            # (P,)
    beta: np.ndarray         # (P,)
    group: np.ndarray        # (P,) int
    program: np.ndarray      # (G,)
    decisions: np.ndarray    # (G,)


@dataclasses.dataclass
class Swaps:
    """The final state of every rung as checked rows (``rungs`` (K, W)
    rows of ``Rows``), the ladder's beta differences (K-1,) and, for each
    boundary, the share of swap pairs the program accepted over the
    window and the number of pairs behind it."""

    rungs: np.ndarray
    db: np.ndarray
    program: np.ndarray
    decisions: np.ndarray


def stretch_proposals(rng: np.random.Generator, x: np.ndarray,
                      pool: np.ndarray, start: np.ndarray, H: int,
                      a: float):
    """One stretch proposal per row of ``x`` (n, D): a partner drawn
    uniformly from rows ``start .. start + H - 1`` of ``pool`` (N, D) (the
    other half of the row's ensemble), a factor z on [1/a, a] with density
    proportional to 1/sqrt(z) (Goodman & Weare 2010).  Returns ``(y (n,
    D), z (n,))`` in float64."""
    n = len(x)
    xp = pool[start + rng.integers(0, H, n)].astype(np.float64)
    s = np.sqrt(a)
    z = ((s - 1.0 / s) * rng.random(n) + 1.0 / s) ** 2
    return xp + z[:, None] * (x.astype(np.float64) - xp), z


def other_half(W: int, w: np.ndarray) -> np.ndarray:
    """(n,) first walker of the half of an ensemble of W walkers that the
    walkers ``w`` draw their partners from."""
    H = W // 2
    return np.where(w < H, H, 0)


def program_session(cfg_path, device, names_ref):
    from joxsz_torch.build import build_session
    from joxsz_torch.config import JoXSZConfig

    sess = build_session(JoXSZConfig.from_json(cfg_path.read_text()),
                         device=device)
    if list(sess.params.thawed) != list(names_ref):
        raise RuntimeError("the program's thawed parameters "
                           f"{sess.params.thawed} differ from the "
                           f"reference's {names_ref}")
    return sess


def part(parts: dict, key: str, t: float) -> float:
    now = time.perf_counter()
    parts[key] = round(now - t, 3)
    return now


def sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def kind(name: str, bench: pathlib.Path = BENCH):
    """The ``Jobs`` class of ``traffic/<name>.py``."""
    path = bench / "traffic" / f"{name}.py"
    if not path.exists():
        raise SystemExit(f"no traffic kind {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_traffic_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Jobs


def make(config: dict, traffic: dict, seed: int, workdir, device,
         bench: pathlib.Path = BENCH):
    return kind(traffic["kind"], bench)(config, traffic, seed, workdir,
                                        device)
