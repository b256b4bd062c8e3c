"""Port parity: ``joxsz_torch.build`` against ``joxsz_tpu.build``.

Both packages build a session from the same small synthetic joint dataset
(``joxsz_torch.synth``, made from a seed with numpy: six annuli, six SZ
points, the ten CL J1226 bands and the bundled count-rate table).  The
operator, data and prior arrays must agree to 1e-12; the arrays a JAX
``FitSession`` holds must carry across through ``session_from_arrays``.

The helpers here (``small_config``, ``jax_session``, ``jax_arrays``) are
shared by the other ``test_torch_*`` files.
"""

import numpy as np
import pytest
import torch

from joxsz_torch.build import (build_session, session_arrays,
                               session_from_arrays)
from joxsz_torch.config import MCMCConfig, resolve_mcmc_schedule
from joxsz_torch.synth import TRUTH, write_synthetic_dataset
from joxsz_tpu.build import build_session as jax_build_session
from joxsz_tpu.config import JoXSZConfig as JaxConfig

TOL = 1e-12


def small_config(root, seed: int = 3):
    """A small joint dataset under ``root``: 6 annuli x 10 bands, 6 SZ
    points out to 30", a 50-point pressure grid."""
    return write_synthetic_dataset(str(root), seed, n_annuli=6, n_sz=6,
                                   max_radius_arcsec=30.0, extent_kpc=800.0)


def jax_session(cfg, dtype: str = "float64"):
    """The JAX package's session of the same config (no operator cache)."""
    jc = JaxConfig.from_json(cfg.to_json())
    jc.dtype = dtype
    return jax_build_session(jc, use_cache=False)


def jax_arrays(js) -> dict:
    """The arrays that define a JAX ``FitSession``'s likelihood, keyed as
    ``joxsz_torch.build.session_from_arrays`` takes them."""
    m, op = js.model, js.sz_operator
    sz, xr, p = m.sz_data, m.xray_data, m.params

    def n(a):
        return np.asarray(a, dtype=np.float64)

    return {
        "sz.L": n(op.L), "sz.G": n(op.G), "sz.w_T0": n(op.w_T0),
        "sz.w_y0": n(op.w_y0), "sz.integ_w": n(op.integ_w),
        "sz.y_prefactor": float(op.y_prefactor),
        "sz.r_press_kpc": n(sz.r_press_kpc), "sz.sep": int(sz.sep),
        "sz.flux_r": n(sz.flux_r), "sz.flux": n(sz.flux),
        "sz.flux_err": n(sz.flux_err), "sz.conv_T": n(sz.conv_T),
        "sz.conv_val": n(sz.conv_val), "sz.calc_integ": bool(sz.calc_integ),
        "sz.integ_mu": float(sz.integ_mu), "sz.integ_sig": float(sz.integ_sig),
        "xray.counts": n(xr.counts), "xray.exposures": n(xr.exposures),
        "xray.areascales": n(xr.areascales), "xray.areas": n(xr.areas),
        "xray.backrates": n(xr.backrates), "xray.vols_norm": n(xr.vols_norm),
        "xray.midpt_kpc": n(xr.midpt_kpc),
        "xray.norm_per_cm3": float(xr.norm_per_cm3),
        "table.Tlog": n(xr.table.Tlog),
        "table.lograte_Z0": n(xr.table.lograte_Z0),
        "table.lograte_Z1": n(xr.table.lograte_Z1),
        "params.names": list(p.names),
        "params.values": np.array([p[k].val for k in p.names]),
        "params.frozen": np.array([p[k].frozen for k in p.names]),
        "params.lo": p.lo, "params.hi": p.hi, "params.is_gauss": p.is_gauss,
        "params.mu": p.mu, "params.sigma": p.sigma,
        "exclude_unphysical_mass": bool(m.exclude_unphysical_mass),
    }


def truth_rows(params, n: int, seed: int, spread: float = 0.03):
    """(n, D) float64 draws around the synthetic data's TRUTH."""
    th0 = np.array([TRUTH[k] for k in params.thawed])
    rng = np.random.default_rng(seed)
    return th0[None] * (1 + spread * rng.standard_normal((n, th0.size)))


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    cfg = small_config(tmp_path_factory.mktemp("torch_build"))
    return cfg, build_session(cfg, device="cpu"), jax_session(cfg)


def _compare(a: dict, b: dict, keys):
    for k in keys:
        va, vb = a[k], b[k]
        if isinstance(va, (list, str)):
            assert list(va) == list(vb), k
            continue
        va, vb = np.asarray(va, dtype=float), np.asarray(vb, dtype=float)
        assert va.shape == vb.shape, (k, va.shape, vb.shape)
        np.testing.assert_allclose(va, vb, rtol=TOL, atol=0, equal_nan=True,
                                   err_msg=k)


GROUPS = {
    "operator": ["sz.L", "sz.G", "sz.w_T0", "sz.w_y0", "sz.integ_w",
                 "sz.y_prefactor"],
    "sz_data": ["sz.r_press_kpc", "sz.sep", "sz.flux_r", "sz.flux",
                "sz.flux_err", "sz.conv_T", "sz.conv_val", "sz.calc_integ",
                "sz.integ_mu", "sz.integ_sig"],
    "xray_data": ["xray.counts", "xray.exposures", "xray.areascales",
                  "xray.areas", "xray.backrates", "xray.vols_norm",
                  "xray.midpt_kpc", "xray.norm_per_cm3"],
    "table": ["table.Tlog", "table.lograte_Z0", "table.lograte_Z1"],
    "params": ["params.names", "params.values", "params.frozen",
               "params.lo", "params.hi", "params.is_gauss", "params.mu",
               "params.sigma", "exclude_unphysical_mass"],
}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_build_session_matches_jax(sessions, group):
    _, sess, js = sessions
    _compare(session_arrays(sess), jax_arrays(js), GROUPS[group])


def test_session_thawed_layout(sessions):
    _, sess, js = sessions
    assert sess.params.thawed == js.params.thawed
    assert len(sess.params.thawed) == 13
    assert sess.device == torch.device("cpu")
    assert sess.model.sz_data.L.dtype == torch.float64


def test_session_from_arrays_roundtrip(sessions):
    """JAX arrays -> port session -> arrays is the identity, and the
    session computes the same likelihood as the port's own build."""
    _, sess, js = sessions
    arrays = jax_arrays(js)
    back = session_from_arrays(arrays, device="cpu")
    _compare(session_arrays(back), arrays, sorted(arrays))
    rows = torch.tensor(truth_rows(sess.params, 8, seed=5))
    a = back.model.log_like_batch(rows).numpy()
    b = sess.model.log_like_batch(rows).numpy()
    assert np.all(np.isfinite(b))
    np.testing.assert_allclose(a, b, rtol=TOL, atol=0)


def test_entry_points_need_gpu_or_cpu_request(sessions, monkeypatch,
                                              tmp_path):
    """Without a card and without an explicit CPU request, the entry
    points raise instead of running on the CPU."""
    from joxsz_torch import run
    from joxsz_torch.synth import config_json

    cfg, _, _ = sessions
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_session(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        session_from_arrays(session_arrays(sessions[1]))
    path = config_json(cfg, tmp_path / "cfg.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--config", path, "--quick"])


@pytest.mark.parametrize("device,quick,from_config,production", [
    ("cuda", False, False, True),
    ("cpu", False, False, False),
    ("cuda", True, False, False),
    ("cuda", False, True, False),
])
def test_resolve_mcmc_schedule(device, quick, from_config, production):
    mine = MCMCConfig(seed=7, initspread=0.2, prelim_iterations=300)
    out, applied = resolve_mcmc_schedule(mine, device=device, quick=quick,
                                         from_config=from_config)
    assert applied is production
    if production:
        want = MCMCConfig.converged_gpu()
        assert (out.nwalkers, out.n_temper_rungs, out.nburn, out.nsteps,
                out.nthin, out.auto_extend) == (
            want.nwalkers, want.n_temper_rungs, want.nburn, want.nsteps,
            want.nthin, want.auto_extend) == (1024, 4, 4000, 8000, 25, 3)
        assert (out.seed, out.initspread, out.prelim_iterations) == (
            7, 0.2, 300)
    else:
        assert out is mine
