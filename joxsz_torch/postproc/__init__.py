"""Posterior post-processing: the summary table and convergence
statistics (``summary``), thermodynamic / mass / gas-fraction profile
bands and the predictive bands (``profiles``), posterior-predictive
p-values (``ppc``) and the CL J1226 regression pin (``pin``)."""

from .profiles import (
    equal_tailed, cumulative_gas_mass, ProfileSet, make_profile_fns,
    compute_profiles, compute_mass_profiles, compute_gas_fraction,
    posterior_predictive,
)
from .summary import (
    integrated_autocorr_time, effective_samples, summary_dict, save_summary,
    chain_tau_steps, collect_kernel_subchain, convergence_rhat, split_rhat,
)
from .ppc import posterior_predictive_pvalues, PPCResult
from .pin import load_pin, check_pin

__all__ = [
    "load_pin", "check_pin",
    "equal_tailed", "cumulative_gas_mass", "ProfileSet", "make_profile_fns",
    "compute_profiles", "compute_mass_profiles", "compute_gas_fraction",
    "posterior_predictive", "integrated_autocorr_time", "effective_samples",
    "summary_dict", "save_summary", "chain_tau_steps",
    "collect_kernel_subchain", "convergence_rhat", "split_rhat",
    "posterior_predictive_pvalues", "PPCResult",
]
