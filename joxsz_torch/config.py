"""Typed configuration covering every knob of the reference.

The reference configures by editing ~30 module-level globals
(reference joxsz_main.py:21-88; SURVEY.md §5.6).  Each of those
becomes a field here; ``JoXSZConfig.cl1226()`` reproduces the bundled
CL J1226.9+3332 setup exactly.  The CLI (``python -m joxsz_torch.run``)
accepts a JSON config file plus field overrides.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib


# the ten CL J1226.9+3332 X-ray bands (eV), reference joxsz_main.py
CL1226_BANDS_EV = ((700, 1000), (1000, 1300), (1300, 1600), (1600, 2000),
                   (2000, 2700), (2700, 3400), (3400, 3800), (3800, 4300),
                   (4300, 5000), (5000, 7000))


@dataclasses.dataclass
class SZConfig:
    beam_file: str | None = None
    tf_file: str | None = None
    flux_file: str = ""
    conversion_file: str = ""
    beam_approx: bool = False
    tf_approx: bool = False
    fwhm_beam_arcsec: float | None = None      # used when beam_approx
    tf_loc: float = 0.0                        # normal-cdf approx params
    tf_scale: float = 0.02
    tf_c: float = 0.95
    calc_integ: bool = False                   # integrated-Y prior
    integ_mu: float = 0.94e-3
    integ_sig: float = 0.36e-3


@dataclasses.dataclass
class XrayConfig:
    fg_template: str = ""
    bg_template: str = ""
    rmf: str = ""
    arf: str = ""
    bands_eV: tuple = ()
    NH_1022pcm2: float = 0.0183
    Z_solar: float = 0.3
    table_path: str | None = None              # pre-generated count-rate table
    # thaw the line_scale nuisance (Gaussian N(1, 0.25)) to marginalize the
    # fallback spectral model's anchored line-emissivity systematic into
    # the posterior (PARITY.md #1) instead of documenting it
    line_systematic: bool = False


@dataclasses.dataclass
class MCMCConfig:
    nwalkers: int = 30
    nburn: int = 2000
    nsteps: int = 5000
    nthin: int = 5
    seed: int | None = None
    initspread: float = 0.1                    # walker init perturbation
    prelim_iterations: int = 1000              # preliminary improvement loop
    n_temper_rungs: int = 0                    # parallel-tempering rungs
    #                                            (0/1 = plain ensemble)
    auto_extend: int = 0                       # convergence-driven
    #                                            extension budget (chunks)

    @classmethod
    def converged_gpu(cls) -> "MCMCConfig":
        """The production schedule of a flagless fit on the card.

        W=1024 walkers x K=4 tempering rungs, 4000 burn-in and 8000
        sampling steps thinned by 25, with up to 3 convergence-driven
        extensions — the schedule the JAX package measured to pass the
        convergence bar (tau-thinned split-Rhat <= 1.01) on the bundled
        CL J1226 joint posterior.  The reference's 30-walker plain-GW
        schedule piles Z/epsilon at 0 (an ensemble-size artifact) and
        never certifies convergence.  The stopping rule ends the run at
        the bar, not at the budget."""
        return cls(nwalkers=1024, nburn=4000, nsteps=8000, nthin=25,
                   n_temper_rungs=4, auto_extend=3)


def resolve_mcmc_schedule(mcmc: MCMCConfig, *, device: str,
                          reference_schedule: bool = False,
                          quick: bool = False,
                          from_config: bool = False) -> tuple[MCMCConfig,
                                                              bool]:
    """Resolve the sampling schedule for a CLI run.

    On a CUDA device the flagless default is the production recipe
    (``MCMCConfig.converged_gpu``; supersedes reference
    joxsz_main.py:42-46).

    The production recipe is NOT applied when: the device is the CPU (a
    W=1024 x K=4 run is hours there; the CPU is the parity/test path),
    ``quick`` smoke runs, an explicit user JSON config (``from_config``)
    — user schedules are never stomped — or ``reference_schedule`` (the
    reference's 30-walker plain-GW schedule, kept for parity studies,
    ``joxsz_tpu/config.py::resolve_mcmc_schedule``).  Non-schedule
    fields (seed, initspread, prelim_iterations) always carry over from
    the incoming config.

    Returns ``(schedule, production_applied)``."""
    if device != "cuda" or reference_schedule or quick or from_config:
        return mcmc, False
    out = MCMCConfig.converged_gpu()
    out.seed = mcmc.seed
    out.initspread = mcmc.initspread
    out.prelim_iterations = mcmc.prelim_iterations
    return out, True


@dataclasses.dataclass
class JoXSZConfig:
    # sampling step in arcsec for the SZ map (joxsz_main.py:21)
    step_arcsec: float = 2.0
    # radial cluster extent (kpc), upper bound of the y integration
    cluster_extent_kpc: float = 5000.0
    # cosmology
    redshift: float = 0.888
    H0: float = 67.32
    WM: float = 0.3158
    WV: float = 0.6842
    # outputs
    name: str = "joxsz"
    plot_dir: str = "./"
    save_dir: str = "./"
    ci: int = 95                               # credible-interval level
    exclude_unphysical_mass: bool = True
    # model selection (BASELINE config #4: alternative parametrizations)
    pressure_model: str = "gnfw"               # gnfw|knots
    n_pressure_knots: int = 7                  # for pressure_model="knots"
    temperature_model: str = "upp"             # upp|vikhlinin
    density_mode: str = "single"               # single|double (Vikhlinin)
    # numerics
    dtype: str = "float64"                     # float64|float32|bfloat16
    abel_scheme: str = "pyabel"                # pyabel|exact-linear
    sz: SZConfig = dataclasses.field(default_factory=SZConfig)
    xray: XrayConfig | None = None
    mcmc: MCMCConfig = dataclasses.field(default_factory=MCMCConfig)

    @classmethod
    def cl1226(cls, data_dir: str,
               table_path: str | None = None) -> "JoXSZConfig":
        """The bundled CL J1226.9+3332 configuration (reference defaults)."""
        d = pathlib.Path(data_dir)
        bands = CL1226_BANDS_EV
        if table_path is None:
            repo = pathlib.Path(__file__).resolve().parents[1]
            cand = repo / "data" / "tables" / "cl1226_ctrate.npz"
            table_path = str(cand) if cand.exists() else None
        return cls(
            sz=SZConfig(
                beam_file=str(d / "SZ/Beam150GHz.fits"),
                tf_file=str(d / "SZ/TransferFunction150GHz_CLJ1227.fits"),
                flux_file=str(d / "SZ/press_data_cl1226_flagsource_Xraycent.dat"),
                conversion_file=str(d / "SZ/Compton_to_Jy_per_beam.dat"),
            ),
            xray=XrayConfig(
                fg_template=str(d / "X/fg_profnew_%04i_%04i.dat"),
                bg_template=str(d / "X/bg_profnew_%04i_%04i.dat"),
                rmf=str(d / "X/source.rmf"),
                arf=str(d / "X/source.arf"),
                bands_eV=bands,
                table_path=table_path,
            ),
        )

    # -- (de)serialisation ---------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "JoXSZConfig":
        raw = json.loads(text)
        sz = SZConfig(**raw.pop("sz", {}))
        xr = raw.pop("xray", None)
        if xr:
            # bands_eV may be omitted (XrayConfig declares a default);
            # only normalise it to tuples when present — indexing it
            # unconditionally made every partial xray override config
            # unloadable with a bare KeyError
            if "bands_eV" in xr:
                xr = {**xr, "bands_eV": tuple(map(tuple, xr["bands_eV"]))}
            xray = XrayConfig(**xr)
        else:
            xray = None
        mcmc = MCMCConfig(**raw.pop("mcmc", {}))
        return cls(sz=sz, xray=xray, mcmc=mcmc, **raw)
