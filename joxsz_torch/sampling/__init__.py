"""Samplers: the stretch move and parallel tempering (plain torch move
law, ``stretch``/``tempered``), the kernel-driven runners (``kernel``),
the MLE warm start (``mle``), the fit driver (``driver``), and the
gradient and evidence samplers (``hmc``, ``nuts``, ``laplace``,
``evidence``, ``sbc``, ``priors``).

The names of ``joxsz_tpu/sampling/__init__.py`` are exported, resolved
on first use: ``ops`` imports ``sampling.stretch``, and ``sampling.
kernel`` imports ``ops``, so an eager import here would be circular.
"""

import importlib

_EXPORTS = {
    "stretch": ("run_ensemble", "make_step", "generate_init_positions",
                "EnsembleResult"),
    "tempered": ("run_tempered_ensemble", "default_betas", "TemperedResult"),
    "evidence": ("run_evidence_ladder", "model_evidence", "power_betas",
                 "EvidenceResult"),
    "mle": ("find_mle", "find_mle_multistart"),
    "laplace": ("laplace_approximation", "laplace_fit", "model_laplace",
                "LaplaceResult"),
    "priors": ("sample_prior", "prior_log_norm"),
    "sbc": ("run_sbc", "sbc_uniformity", "run_batched_ensembles",
            "SBCResult"),
    "hmc": ("run_hmc", "HMCResult"),
    "nuts": ("run_nuts", "NUTSResult"),
    "kernel": ("make_kernel_sampler", "KernelSampler"),
    "driver": ("run_fit", "FitResult"),
}
_WHERE = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = list(_WHERE)


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
