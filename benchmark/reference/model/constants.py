"""Physical constants (CGS) used throughout the framework.

The constant set mirrors the values consumed by the reference through
``mbproj2.physconstants`` (see reference joxsz_funcs.py:6 and
reference joxsz_plots.py:5 for the imported names).  mbproj2 is not
vendored in the reference mount, so the values below are standard CGS values
consistent with the public mbproj2 constant set; posterior-level parity is
insensitive to <=1e-4 relative differences here (they rescale profiles far
below the Monte-Carlo error of the fit).
"""

# --- unit conversions -------------------------------------------------------
kpc_cm = 3.0856775807e21        # cm per kpc
Mpc_cm = 3.0856775807e24        # cm per Mpc
Mpc_km = 3.0856775807e19        # km per Mpc
yr_s = 31556926.0               # seconds per (tropical) year
keV_erg = 1.6021766e-9          # erg per keV
keV_K = 1.160451812e7           # Kelvin per keV (CODATA 2018)
erg_keV = 1.0 / keV_erg

# --- physical constants -----------------------------------------------------
G_cgs = 6.67428e-8              # gravitational constant (cm^3 g^-1 s^-2)
solar_mass_g = 1.98892e33       # solar mass (g)
mu_g = 1.6605402e-24            # atomic mass unit (g)
boltzmann_erg_K = 1.3806488e-16 # Boltzmann constant (erg/K)
c_km_s = 299792.458             # speed of light (km/s)

# --- plasma composition (fully ionised ICM, ~0.3 solar) --------------------
ne_nH = 1.2                     # electron-to-hydrogen number-density ratio
mu_e = 1.18                     # mean gas mass per electron, in a.m.u.
mu_gas = 0.61                   # mean molecular weight of the gas
                                # (default of CmptMyMass.mass_fun,
                                #  reference joxsz_funcs.py:428)

# --- SZ-specific constants (reference config values) ------------------------
# electron rest mass in keV/c^2 (reference joxsz_main.py:22)
m_e_keV = 0.5109989e3
# Thomson cross-section in cm^2 (reference joxsz_main.py:23)
sigma_T_cm2 = 6.6524587158e-25
