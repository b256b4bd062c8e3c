"""Posterior diagnostics (the convergence statistics of the stopping
rule); tables, figures and predictive checks wait for a later slice."""
