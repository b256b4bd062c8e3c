"""Port parity: count-rate table generation (``io/ogip.py``,
``tablegen/``) and ``build.find_table`` generating a missing table.

* ``io.ogip`` against ``joxsz_tpu.io.ogip`` on the synthetic RMFs of
  ``tests/test_ogip.py`` (both F_CHAN conventions, and the inconsistent
  numbering both refuse) and on ``synth.write_synthetic_response`` (1000
  energies x 1024 channels): exact;
* ``tablegen.spectrum`` on float64 tensors against the numpy spectrum of
  ``joxsz_tpu/tablegen/spectrum.py`` over a (T, Z, E) grid: rtol 1e-12;
* ``generate_table`` (torch, CPU) against ``joxsz_tpu``'s
  ``generate_table(backend="numpy")``: rtol 1e-10, the same metadata but
  the backend's name, the same ``TableSpec`` repr and key;
* ``find_table`` generates a table once into the tables directory (here
  ``tmp_path``; no test writes into the repository) and finds it on the
  next build; a config with no ``table_path`` at z = 0.5 builds and fits;
* ``tablegen.import_xspec_cache``: the cases of
  ``tests/test_xspec_import.py``, and the result against ``joxsz_tpu``'s.
"""

import json

import numpy as np
import pytest
import torch

from joxsz_torch import build, run
from joxsz_torch.io import ogip
from joxsz_torch.synth import (CL1226_BANDS_EV, config_json,
                               write_synthetic_dataset,
                               write_synthetic_response)
from joxsz_torch.tablegen import generate as gen
from joxsz_torch.tablegen import spectrum as sp
from joxsz_torch.tablegen.import_xspec_cache import (CacheKeyError,
                                                     import_cache, read_cache)
from joxsz_tpu.io import ogip as jogip
from joxsz_tpu.tablegen import generate as jgen
from joxsz_tpu.tablegen import import_xspec_cache as jimp
from joxsz_tpu.tablegen import spectrum as jsp

from tests.test_ogip import _write_rmf
from tests.test_xspec_import import (ARF_REMOTE, BANDS, NH, NT, RMF_REMOTE,
                                     Z, _reference_textkey, _synthetic_rates)

RESPONSE_FIELDS = ("energ_lo", "energ_hi", "matrix", "chan_e_min",
                   "chan_e_max", "specresp")
CL_BANDS = tuple(tuple(b) for b in CL1226_BANDS_EV)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The CPU tests run torch on one thread: once, in a worker of the
    parallel suite, the batched spectrum came out 3e-9 off the numpy one
    on exactly one thread's share of the grid, which no single-process
    or loaded rerun reproduced."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def response(tmp_path_factory):
    return write_synthetic_response(tmp_path_factory.mktemp("torch_resp"))


# -- io.ogip -----------------------------------------------------------------

@pytest.mark.parametrize("f_chan, tlmin4, eb_first", [
    ([0, 2], 0, 1), ([1, 3], None, 1), ([5, 7], 5, 5)])
def test_rmf_matches_jax_reader(tmp_path, f_chan, tlmin4, eb_first):
    p = _write_rmf(tmp_path / "r.rmf", f_chan=f_chan, tlmin4=tlmin4,
                   eb_first=eb_first)
    a, b = ogip.read_rmf(p), jogip.read_rmf(p)
    for f in RESPONSE_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_allclose(a.matrix[0], [0.7, 0.3, 0.0, 0.0], rtol=1e-7)


def test_rmf_inconsistent_numbering_refused_by_both(tmp_path):
    p = _write_rmf(tmp_path / "c.rmf", f_chan=[0, 2], eb_first=1)
    for reader in (ogip.read_rmf, jogip.read_rmf):
        with pytest.raises(ValueError, match="channel numbering"):
            reader(p)


def test_synthetic_response_matches_jax_reader(response):
    rmf, arf = response
    a, b = ogip.load_response(rmf, arf), jogip.load_response(rmf, arf)
    for f in RESPONSE_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.matrix.shape == (1000, 1024)
    np.testing.assert_allclose(a.matrix.sum(axis=1), 0.98, rtol=1e-6)
    assert np.array_equal(a.folded(), b.folded())
    masks = gen.band_masks(a, CL_BANDS)
    assert masks.shape == (10, 1024) and np.all(masks.sum(axis=1) > 10)


def test_arf_grid_must_match(response, tmp_path):
    rmf, _ = response
    other = write_synthetic_response(tmp_path)[1]
    ogip.load_response(rmf, other)
    lo, hi, area = ogip.read_arf(other)
    assert area.shape == (1000,) and area.max() > 500.0


# -- the spectrum ------------------------------------------------------------

T_GRID = np.exp(np.linspace(np.log(0.06), np.log(60.0), 64))
E_GRID = np.geomspace(0.05, 12.0, 700)


def test_spectrum_matches_numpy():
    E = torch.tensor(E_GRID)
    T = torch.tensor(T_GRID)[:, None]
    Zs = torch.tensor([0.0, 0.3, 1.0], dtype=torch.float64)[:, None, None]
    got = sp.observed_photon_flux(E, T, Zs, 0.888, 0.0183).numpy()
    assert got.shape == (3, 64, 700)
    for iz, Zv in enumerate((0.0, 0.3, 1.0)):
        for it, Tv in enumerate(T_GRID):
            want = jsp.observed_photon_flux(E_GRID, Tv, Zv, 0.888, 0.0183)
            np.testing.assert_allclose(got[iz, it], want, rtol=1e-12,
                                       atol=0)
    np.testing.assert_allclose(
        sp.gaunt_ff(E[None], T).numpy(),
        np.stack([jsp.gaunt_ff(E_GRID, Tv) for Tv in T_GRID]), rtol=1e-12)
    np.testing.assert_allclose(sp.mm83_sigma_1e24cm2(E).numpy(),
                               jsp.mm83_sigma_1e24cm2(E_GRID), rtol=1e-12)
    np.testing.assert_allclose(sp.phabs_transmission(E, 0.3).numpy(),
                               jsp.phabs_transmission(E_GRID, 0.3),
                               rtol=1e-12)


def test_bolometric_flux_matches_numpy():
    got = sp.bolometric_flux_per_norm(
        torch.tensor(T_GRID[::7])[:, None],
        torch.tensor([0.0, 1.0])[:, None, None], 0.5).numpy()
    want = np.array([[jsp.bolometric_flux_per_norm(Tv, Zv, 0.5)
                      for Tv in T_GRID[::7]] for Zv in (0.0, 1.0)])
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_bessel_k0_matches_scipy_over_the_grids_arguments():
    """torch's K0 against scipy's over every x = E / 2kT the table
    generator can ask for (clipped to [1e-8, 600])."""
    from scipy.special import k0

    x = np.clip(np.concatenate([np.geomspace(1e-8, 600.0, 20001),
                                (E_GRID[None] * 1.888 / (2 * T_GRID[:, None]))
                                .ravel()]), 1e-8, 600.0)
    got = torch.special.modified_bessel_k0(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, k0(x), rtol=1e-13)


# -- generate_table ----------------------------------------------------------

@pytest.mark.parametrize("z, nh", [(0.5, 0.0183), (0.888, 0.05)])
def test_generate_table_matches_jax_numpy(response, z, nh):
    rmf, arf = response
    spec = gen.TableSpec(rmf=rmf, arf=arf, bands_eV=CL_BANDS, z=z,
                         NH_1022pcm2=nh)
    jspec = jgen.TableSpec(rmf=rmf, arf=arf, bands_eV=CL_BANDS, z=z,
                           NH_1022pcm2=nh)
    assert repr(spec) == repr(jspec)
    assert spec.key() == build.TableSpec(**vars(spec)).key()
    a = gen.generate_table(spec, device="cpu")
    b = jgen.generate_table(jspec, backend="numpy")
    assert set(a) == set(b)
    for k in ("Tlog", "lograte_Z0", "lograte_Z1", "logflux_Z0",
              "logflux_Z1", "bands_eV"):
        assert a[k].shape == b[k].shape, k
        np.testing.assert_allclose(a[k], b[k], rtol=1e-10, atol=0,
                                   err_msg=k)
    ma, mb = (json.loads(t["meta"].item()) for t in (a, b))
    assert ma.pop("backend") == "torch" and mb.pop("backend") == "numpy"
    assert ma == mb


def test_generate_cli_writes_a_loadable_table(response, tmp_path):
    rmf, arf = response
    out = tmp_path / "t.npz"
    gen.main(["--rmf", rmf, "--arf", arf, "--z", "0.5", "--nh", "0.0183",
              "--out", str(out), "--cpu", "--nT", "32"])
    from joxsz_torch.models.xray import CountRateTable

    t = CountRateTable.from_npz(str(out), dtype=torch.float64, device="cpu",
                                expect={"z": 0.5, "NH_1022pcm2": 0.0183,
                                        "bands_eV": CL_BANDS,
                                        "model_version": 2})
    assert t.lograte_Z0.shape == (10, 32)


def test_generate_table_refuses_a_band_without_channels(response):
    rmf, arf = response
    spec = gen.TableSpec(rmf=rmf, arf=arf, bands_eV=((20000, 21000),),
                         z=0.5, NH_1022pcm2=0.0183)
    with pytest.raises(ValueError, match="no channels"):
        gen.generate_table(spec, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        gen.generate_table(spec, backend="numpy", device="cpu")


# -- find_table --------------------------------------------------------------

@pytest.fixture
def tables_dir(tmp_path, monkeypatch):
    d = tmp_path / "tables"
    monkeypatch.setattr(build, "TABLES_DIR", d)
    return d


def _small_response_dataset(root, z=0.5):
    return write_synthetic_dataset(str(root), 3, n_annuli=6, n_sz=6,
                                   max_radius_arcsec=30.0, extent_kpc=800.0,
                                   redshift=z, response=True)


def test_find_table_generates_once_then_hits(tmp_path, tables_dir,
                                             monkeypatch):
    cfg = _small_response_dataset(tmp_path / "data")
    assert cfg.xray.table_path is None
    calls = []
    real = build.generate_table

    def spy(spec, **kw):
        calls.append(spec)
        return real(spec, **kw)

    monkeypatch.setattr(build, "generate_table", spy)
    s1 = build.build_session(cfg, device="cpu")
    path = tables_dir / f"ctrate_{calls[0].key()}.npz"
    assert path.exists() and len(calls) == 1
    assert calls[0].z == 0.5 and calls[0].rmf == cfg.xray.rmf
    s2 = build.build_session(cfg, device="cpu")
    assert len(calls) == 1
    assert build.find_table(cfg) == str(path)
    assert torch.equal(s1.model.xray_data.table.lograte_Z1,
                       s2.model.xray_data.table.lograte_Z1)
    # the table the session reads is the JAX package's for this config
    j = jgen.generate_table(jgen.TableSpec(
        rmf=cfg.xray.rmf, arf=cfg.xray.arf, bands_eV=CL_BANDS, z=0.5,
        NH_1022pcm2=cfg.xray.NH_1022pcm2), backend="numpy")
    np.testing.assert_allclose(s1.model.xray_data.table.lograte_Z0.numpy(),
                               j["lograte_Z0"], rtol=1e-10)


def test_config_without_a_table_builds_and_fits(tmp_path, tables_dir):
    """A synthetic cluster at z = 0.5 with no table_path: ``run --quick``
    generates its table, then fits through the MLE, prelim, burn and
    tempered sampling on the kernels' plain versions."""
    cfg = _small_response_dataset(tmp_path / "data")
    cfg.save_dir = str(tmp_path / "out")
    path = config_json(cfg, tmp_path / "cfg.json")
    res = run.main(["--config", path, "--cpu", "--quick", "--walkers", "16",
                    "--temper", "2", "--seed", "4", "--no-plots",
                    "--fresh-mle"])
    assert len(list(tables_dir.glob("ctrate_*.npz"))) == 1
    assert np.all(np.isfinite(res.chain))
    assert 0.05 < float(np.mean(res.acceptance_fraction)) < 0.9


# -- import_xspec_cache ------------------------------------------------------

def _spec(bands=BANDS, z=Z, nh=NH):
    return gen.TableSpec(rmf="data/X/source_v2.rmf",
                         arf="data/X/source_v2.arf", bands_eV=bands, z=z,
                         NH_1022pcm2=nh)


@pytest.fixture
def cache_file(tmp_path):
    import h5py

    path = tmp_path / "countrate_cache.hdf5"
    truth = {}
    with h5py.File(path, "w") as f:
        for i, (lo, hi) in enumerate(BANDS):
            rates = _synthetic_rates(i)
            f[_reference_textkey(lo / 1000.0, hi / 1000.0, Z, NH, RMF_REMOTE,
                                 ARF_REMOTE)] = rates
            truth[(lo, hi)] = rates
    return path, truth


def test_import_roundtrip_exact_and_as_jax(cache_file, tmp_path):
    path, truth = cache_file
    table = import_cache(str(path), _spec(), device="cpu")
    for i, b in enumerate(BANDS):
        np.testing.assert_array_equal(table["lograte_Z0"][i],
                                      np.log(truth[b][0]))
        np.testing.assert_array_equal(table["lograte_Z1"][i],
                                      np.log(truth[b][1]))
    assert table["Tlog"].shape == (NT,)
    meta = json.loads(table["meta"].item())
    assert meta["backend"] == "xspec-cache"
    assert len(meta["source_keys"]) == len(BANDS)
    j = jimp.import_cache(str(path), jgen.TableSpec(**vars(_spec())))
    assert set(table) == set(j)
    for k in ("Tlog", "lograte_Z0", "lograte_Z1", "bands_eV"):
        np.testing.assert_array_equal(table[k], j[k])
    for k in ("logflux_Z0", "logflux_Z1"):
        np.testing.assert_allclose(table[k], j[k], rtol=1e-12)
    assert meta == json.loads(j["meta"].item())
    # the artifact loads under the metadata guard: an xspec-cache table
    # is exempt from the fallback model's version
    from joxsz_torch.models.xray import CountRateTable

    out = tmp_path / "imported.npz"
    gen.save_table(str(out), table)
    t = CountRateTable.from_npz(str(out), dtype=torch.float64, device="cpu",
                                expect={"z": Z, "NH_1022pcm2": NH,
                                        "bands_eV": BANDS,
                                        "model_version": 99})
    assert t.lograte_Z0.shape == (len(BANDS), NT)


def test_float_string_tolerance(tmp_path):
    import h5py

    path = tmp_path / "c.hdf5"
    with h5py.File(path, "w") as f:
        f["0.70_1.00_0.8880_0.01830_src.rmf_src.arf"] = _synthetic_rates(0)
    table = import_cache(str(path), gen.TableSpec(
        rmf="src.rmf", arf="src.arf", bands_eV=((700, 1000),), z=0.888,
        NH_1022pcm2=0.0183), device="cpu")
    assert table["lograte_Z0"].shape == (1, NT)


@pytest.mark.parametrize("spec, match", [
    (_spec(bands=BANDS + ((5000, 7000),)), "not found"),
    (_spec(z=0.3), "not found"),
    (_spec(nh=0.1), "not found"),
    (gen.TableSpec(rmf="other.rmf", arf="other.arf", bands_eV=BANDS, z=Z,
                   NH_1022pcm2=NH), "different responses"),
    # exact basenames, not suffixes: v2.rmf is another file
    (gen.TableSpec(rmf="v2.rmf", arf="v2.arf", bands_eV=BANDS, z=Z,
                   NH_1022pcm2=NH), "different responses"),
], ids=["missing_band", "wrong_z", "wrong_nh", "wrong_response",
        "basename_suffix"])
def test_mismatched_key_fails_loudly(cache_file, spec, match):
    path, _ = cache_file
    with pytest.raises(CacheKeyError, match=match):
        import_cache(str(path), spec, device="cpu")


def test_underscored_basenames_match(tmp_path):
    import h5py

    path = tmp_path / "cache.hdf5"
    with h5py.File(path, "w") as f:
        f[_reference_textkey(0.7, 1.0, Z, NH, "/d_a/xmm_source.rmf",
                             "/d_a/xmm_source.arf")] = _synthetic_rates(0)
    ok = gen.TableSpec(rmf="xmm_source.rmf", arf="xmm_source.arf",
                       bands_eV=((700, 1000),), z=Z, NH_1022pcm2=NH)
    assert import_cache(str(path), ok, device="cpu")[
        "lograte_Z0"].shape[0] == 1
    bad = gen.TableSpec(rmf="source.rmf", arf="source.arf",
                        bands_eV=((700, 1000),), z=Z, NH_1022pcm2=NH)
    with pytest.raises(CacheKeyError, match="different responses"):
        import_cache(str(path), bad, device="cpu")


def _write_cache(path, entries):
    import h5py

    with h5py.File(path, "w") as f:
        for k, v in entries.items():
            f[k] = v
    return str(path)


def test_inconsistent_nT_fails(tmp_path):
    p = _write_cache(tmp_path / "c.hdf5", {
        _reference_textkey(0.7, 1.0, Z, NH, "s.rmf", "s.arf"):
            _synthetic_rates(0, nT=64),
        _reference_textkey(1.0, 1.3, Z, NH, "s.rmf", "s.arf"):
            _synthetic_rates(1, nT=32)})
    spec = gen.TableSpec(rmf="s.rmf", arf="s.arf",
                         bands_eV=((700, 1000), (1000, 1300)), z=Z,
                         NH_1022pcm2=NH)
    with pytest.raises(CacheKeyError, match="inconsistent"):
        import_cache(p, spec, device="cpu")


@pytest.mark.parametrize("entries, match", [
    ({_reference_textkey(0.7, 1.0, Z, NH, "s.rmf", "s.arf"):
      np.zeros((3, 5, 2))}, "shape"),
    ({"not_a_valid_key": np.zeros(3)}, "no parseable"),
], ids=["bad_shape", "empty"])
def test_unreadable_cache_fails(tmp_path, entries, match):
    p = _write_cache(tmp_path / "c.hdf5", entries)
    with pytest.raises(CacheKeyError, match=match):
        read_cache(p)


def test_ambiguous_duplicate_fails(tmp_path):
    p = _write_cache(tmp_path / "c.hdf5", {
        "0.7_1.0_0.888_0.0183_s.rmf_s.arf": _synthetic_rates(0),
        "0.70_1.00_0.888_0.0183_s.rmf_s.arf": _synthetic_rates(1)})
    spec = gen.TableSpec(rmf="s.rmf", arf="s.arf", bands_eV=((700, 1000),),
                         z=Z, NH_1022pcm2=NH)
    with pytest.raises(CacheKeyError, match="ambiguous"):
        import_cache(p, spec, device="cpu")


def test_import_cli_roundtrip(cache_file, tmp_path):
    from joxsz_torch.tablegen import import_xspec_cache as mod

    path, truth = cache_file
    out = tmp_path / "out.npz"
    mod.main(["--cache", str(path), "--rmf", "data/X/source_v2.rmf",
              "--arf", "data/X/source_v2.arf", "--z", str(Z), "--nh",
              str(NH), "--bands", ",".join(f"{a}:{b}" for a, b in BANDS),
              "--out", str(out), "--cpu"])
    d = np.load(str(out))
    np.testing.assert_array_equal(d["lograte_Z1"][2],
                                  np.log(truth[BANDS[2]][1]))
