"""Physical constants (CGS unless suffixed _SI).

The constant set used by the reference thermo-chemical
disk code (reference: src/sub_global_variables.f90, module phy_const).  Values
are chosen to match the reference bit-for-bit where the reference pins a
specific (sometimes slightly dated) CODATA draw, because downstream parity
tests compare Tgas/Tdust/abundances against reference outputs.

Everything here is a plain Python float; a copy of the JAX package's
``constants.py`` so that both packages compute with identical values.

Part of the benchmark's plain reference: a frozen copy of the port's
rac2d_torch/constants.py as the benchmark was defined, with its imports
pointed at this package.  Later changes to the port do not reach it.
"""

import math

pi = 3.1415926535897932384626433
pi_2 = pi / 2.0
two_pi = 2.0 * pi
sqrt_2pi = 2.5066282746310005024
ln10 = math.log(10.0)

max_exp = 222.0  # exp() argument clamp used throughout the reference

# --- fundamental ---
elementaryCharge_SI = 1.602176487e-19
electronClassicalRadius_CGS = 2.8179403267e-13
mProton_CGS = 1.67262158e-24        # g
mElectron_CGS = 9.10938188e-28      # g
kBoltzmann_CGS = 1.3806503e-16      # erg/K
kBoltzmann_SI = 1.3806503e-23
hPlanck_CGS = 6.62606896e-27        # erg s
hbarPlanck_CGS = 1.054571628e-27
GravitationConst_CGS = 6.67428e-8
SpeedOfLight_CGS = 2.99792458e10    # cm/s
StefanBoltzmann_CGS = 5.670373e-5
IdealGasConst_SI = 8.314472
ThomsonScatterCross_CGS = 6.6524574e-25
AvogadroConst = 6.02214179e23

# --- astronomical ---
Lsun_CGS = 3.839e33                 # erg/s
Msun_CGS = 1.9891e33                # g
Rsun_CGS = 6.955e10                 # cm
Mearth_CGS = 5.97219e27
Rearth_CGS = 6371e5

SecondsPerYear = 3600.0 * 24.0 * 365.0
Deg2Rad = pi / 180.0
eV2erg = 1.60217657e-12
keV2erg = 1.60217657e-9
cm_1_2erg = hPlanck_CGS * SpeedOfLight_CGS   # 1 cm^-1 in erg
cm_1_2K = cm_1_2erg / kBoltzmann_CGS         # 1 cm^-1 in K
AU2cm = 1.49597871e13
pc2cm = 3.08567758e18
Angstrom2micron = 1e-4
Angstrom2cm = 1e-8
micron2cm = 1e-4
jansky2CGS = 1e-23

CMB_T = 2.72548

# --- ISM / radiation-field scalings ---
ratioDust2GasMass_ISM = 0.01
Habing_photon_energy_CGS = 1.99e-11
LyAlpha_energy_CGS = 1.64e-11
UV_cont_energy_CGS = Habing_photon_energy_CGS
Habing_energy_density_CGS = 5.29e-14   # Draine 2011 eq 12.6
Habing_photon_flux_CGS = 6e7           # cm^-2 s^-1
Habing_energy_flux_CGS = 1.194e-3      # erg cm^-2 s^-1
UVext2Av = 2.6                         # Tielens 2005 eq 3.19

# Lyman-alpha line constants
LyAlpha_nu0 = 2.4660718e15
LyAlpha_l0 = 1215.668       # Angstrom
LyAlpha_dnul = 9.938e7
LyAlpha_f12 = 0.4162

LyAlpha_cross_H2O = 1.2e-17  # Van Dishoeck 2006, Table 1
LyAlpha_cross_OH = 1.8e-18

cosmicray_attenuate_N = 5.75e25  # H column for CR attenuation (96 g cm^-2)
PAH_abundance_0 = 1.6e-7
SitesDensity_CGS = 1e15          # grain surface site density cm^-2

colDen2Av_coeff = 5.3e-22        # Draine 2011 eq 21.7

# Wavelength band edges (micron; defined in Angstrom in the reference,
# src/montecarlo.f90:36-44) for band-integrated radiation fields.
lam_range_Xray = (0.1e-4, 100.0e-4)
lam_range_UV = (900e-4, 2000e-4)
lam_range_UV_H2phd = (900e-4, 1100e-4)
lam_range_LyA = (1210e-4, 1220e-4)
lam_range_LyA_ext = (1100e-4, 1300e-4)
lam_range_Vis = (3000e-4, 8000e-4)
lam_range_NIR = (8000e-4, 5.0)
lam_range_MIR = (5.0, 30.0)
lam_range_FIR = (30.0, 200.0)
