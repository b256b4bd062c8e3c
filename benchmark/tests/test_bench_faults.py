"""The check catches a broken timed path: each run skips the look for a
card and drives the rest of a run on the program's plain versions (CPU,
small ensembles at the configurations' own shapes), with one fault
planted underneath, and ``correct`` comes out false.  The faults of the
sampler's law (every proposal accepted, the stretch move's z^(D-1)
dropped, the swap sweep skipped, half the steps run) run at larger
ensembles, where the reference's expected acceptance is sharp enough to
judge them.  The control (``control.py``: the reference in TF32 in the
program's place) fails at the same sizes, and the program's sound run
passes."""

import pytest
import torch

import joxsz_torch.ops.step_kernel as stk
import joxsz_torch.parallel.kernel_sharded as ks
import joxsz_torch.sampling.kernel as sk
from benchmark.control import readings
from benchmark.harness import manifest
from benchmark.harness.cell import run_cell

TEMPERED = {"schedule": {"walkers": 32, "rungs": 2, "steps": 100,
                         "thin": 25}, "check_frames": 64}
SURVEY = {"clusters": 4, "walkers": 32, "burn_steps": 80, "steps": 160,
          "thin": 80, "last_walkers": 4, "check_frames": 32}
# the law's faults: ensembles whose expected acceptance the check reads
# to a few hundredths
TEMPERED_LAW = {"schedule": {"walkers": 512, "rungs": 2, "steps": 100,
                             "thin": 25}, "check_frames": 1024}
# z^(D-1) dropped moves the share by a few hundredths: a wider ensemble
TEMPERED_WIDE = {"schedule": {"walkers": 1024, "rungs": 2, "steps": 100,
                              "thin": 25}, "check_frames": 2048}
SURVEY_LAW = {"clusters": 4, "walkers": 64, "burn_steps": 80, "steps": 160,
              "thin": 80, "last_walkers": 16, "check_frames": 128}
SEED = 2 ** 31 + 11


def _run(cell, overrides):
    out, compared = run_cell(cell, SEED, 0.0, False, 0.0, device="cpu",
                             overrides=overrides)
    return out["correct"], {k: v["value"] for k, v in compared.items()}


def _unchanged_tempered(real):
    def step(x, lp, acc, sacc, beta, db, seed, n, consts, thin=0, out=None,
             partner=None):
        if thin:
            out[0][:] = x[0]
            out[1][:] = lp[0]
    return step


def _half_tempered(real):
    def step(x, lp, acc, sacc, beta, db, seed, n, consts, thin=0, out=None,
             partner=None):
        h = x.shape[1] // 2
        x0, lp0 = x[:, h:].clone(), lp[:, h:].clone()
        real(x, lp, acc, sacc, beta, db, seed, n, consts, thin=thin,
             out=out, partner=partner)
        x[:, h:], lp[:, h:] = x0, lp0
        if thin:
            out[0][:, h:] = x0[0]
            out[1][:, h:] = lp0[0]
    return step


def _altered_tempered(real):
    def step(x, lp, acc, sacc, beta, db, seed, n, consts, thin=0, out=None,
             partner=None):
        real(x, lp, acc, sacc, beta, db, seed, n, consts, thin=thin,
             out=out, partner=partner)
        lp[:, 0] += 0.5
        if thin:
            out[1][:, 0] += 0.5
    return step


def _unchanged_survey(real):
    def step(x, lp, acc, seed, n, stack, thin=0):
        if thin:
            k = n // thin
            return (x[:, None].expand(-1, k, -1, -1).clone(),
                    lp[:, None].expand(-1, k, -1).clone())
    return step


def _half_survey(real):
    def step(x, lp, acc, seed, n, stack, thin=0):
        h = x.shape[0] // 2
        x0, lp0 = x[h:].clone(), lp[h:].clone()
        frames = real(x, lp, acc, seed, n, stack, thin=thin)
        x[h:], lp[h:] = x0, lp0
        if thin:
            frames[0][h:] = x0[:, None]
            frames[1][h:] = lp0[:, None]
        return frames
    return step


def _altered_survey(real):
    def step(x, lp, acc, seed, n, stack, thin=0):
        frames = real(x, lp, acc, seed, n, stack, thin=thin)
        if thin:
            frames[1][:, -1] += 0.5
        return frames
    return step


def _no_exchange(real):
    # the other cards' blocks never arrive: the first card's stands in
    def gather(blocks, device, dim=0):
        return torch.cat([blocks[0].to(device)] * len(blocks), dim=dim)
    return gather


def _always_accept(real):
    # every stretch proposal taken: the accept draw forced to 0
    def half(lp_fn, u, *a, **k):
        u = u.clone()
        u[..., 2] = 0.0
        return real(lp_fn, u, *a, **k)
    return half


def _no_volume_factor(real):
    # the stretch move's z^(D-1) left out of the acceptance
    def half(lp_fn, u, x_move, lp_move, x_fixed, ndim, *a, **k):
        return real(lp_fn, u, x_move, lp_move, x_fixed, 1, *a, **k)
    return half


def _no_swap(real):
    # the swap sweep skipped: every pair left where it is
    def swap(x, lp, kk, seed, step, bits, db):
        H = x.shape[1] // 2
        return (x, lp, torch.zeros((2, H), dtype=torch.bool),
                torch.zeros((2, H)))
    return swap


def _half_the_steps(real):
    # half of each launch's steps run, the frames filled from its end:
    # fewer steps than the rate counts
    def step(x, lp, acc, sacc, beta, db, seed, n, consts, thin=0, out=None,
             partner=None):
        real(x, lp, acc, sacc, beta, db, seed, n // 2, consts,
             partner=partner)
        if thin:
            out[0][:] = x[0]
            out[1][:] = lp[0]
    return step


def test_sound_runs_pass():
    assert _run("flagship.tempered", TEMPERED)[0]
    assert _run("flagship.survey_c80", SURVEY)[0]


@pytest.mark.parametrize("fault", [_unchanged_tempered, _half_tempered,
                                   _altered_tempered])
def test_tempered_fault_fails(monkeypatch, fault):
    monkeypatch.setattr(sk, "stretch_steps", fault(sk.stretch_steps))
    correct, read = _run("flagship.tempered", TEMPERED)
    assert not correct, read


@pytest.mark.parametrize("fault", [_unchanged_survey, _half_survey,
                                   _altered_survey])
def test_survey_fault_fails(monkeypatch, fault):
    monkeypatch.setattr(sk, "stretch_steps_multicluster",
                        fault(sk.stretch_steps_multicluster))
    correct, read = _run("flagship.survey_c80", SURVEY)
    assert not correct, read


def test_mesh_without_the_exchange_fails(monkeypatch):
    # the survey kind over a mesh of four shards (the CPU stands in for
    # every card)
    mesh = dict(SURVEY, cards=4)
    assert _run("flagship.survey_c80", mesh)[0]
    monkeypatch.setattr(ks, "gather", _no_exchange(ks.gather))
    correct, read = _run("flagship.survey_c80", mesh)
    assert not correct, read


@pytest.mark.parametrize("cell,overrides", [
    ("flagship.tempered", TEMPERED_LAW), ("flagship.survey_c80", SURVEY_LAW)])
def test_sound_law_passes(cell, overrides):
    correct, read = _run(cell, overrides)
    assert correct, read


@pytest.mark.parametrize("cell,overrides,where,fault,number", [
    ("flagship.tempered", TEMPERED_LAW, "stretch_half_update",
     _always_accept, "move_acc_z"),
    ("flagship.survey_c80", SURVEY_LAW, "stretch_half_update",
     _always_accept, "move_acc_z"),
    ("flagship.tempered", TEMPERED_WIDE, "stretch_half_update",
     _no_volume_factor, "move_acc_z"),
    ("flagship.tempered", TEMPERED_LAW, "swap_plain", _no_swap,
     "swap_acc_z"),
    ("flagship.tempered", TEMPERED_LAW, "stretch_steps", _half_the_steps,
     "move_acc_z")])
def test_law_fault_fails(monkeypatch, cell, overrides, where, fault, number):
    mod = sk if where == "stretch_steps" else stk
    monkeypatch.setattr(mod, where, fault(getattr(mod, where)))
    correct, read = _run(cell, overrides)
    limit = manifest.limits({"name": cell})[number]
    assert not correct and read[number] > limit, read


@pytest.mark.parametrize("cell,overrides", [
    ("flagship.tempered", TEMPERED), ("knots_vt.tempered", TEMPERED),
    ("flagship.survey_c80", SURVEY)])
def test_control_fails(cell, overrides):
    (row,) = readings(cell, [SEED], device="cpu", overrides=overrides)
    assert row["correct"]
    assert not row["control"]["correct"], row
