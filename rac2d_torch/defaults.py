"""Paths to the data files shipped with the repository.

The files live in the JAX package's data directory and are read there in
place, by path; this package does not import the JAX package.
"""

import pathlib

DATA = pathlib.Path(__file__).resolve().parent.parent / "rac2d_tpu" / "data"

NETWORK = str(DATA / "chem" / "rate06_withgrain.dat")
INIT_ABUNDANCES = str(DATA / "chem" / "initial_condition_Garrod08_mod.dat")
ENTHALPIES = str(DATA / "chem" / "Species_enthalpy.dat")
SILICATE_OPTI = str(DATA / "dust" / "silicate_draine.opti")
H2O_PHOTOXS = str(DATA / "star" / "H2O.photoxs")
TWHYA_SPECTRUM = str(DATA / "star" / "tw_hya_spec_combined.dat")
GRAPHITE_OPTI = str(DATA / "dust" / "graphite_draine_pa_0.01.opti")
CO_LAMDA = str(DATA / "co_lamda.dat")
H2O_LAMDA = str(DATA / "h2o_lamda.dat")
