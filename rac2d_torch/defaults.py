"""Paths to the data files shipped with the repository.

The files live in the JAX package's data directory and are read there in
place, by path; this package does not import the JAX package.
"""

import pathlib

DATA = pathlib.Path(__file__).resolve().parent.parent / "rac2d_tpu" / "data"

NETWORK = str(DATA / "chem" / "rate06_withgrain.dat")
INIT_ABUNDANCES = str(DATA / "chem" / "initial_condition_Garrod08_mod.dat")
ENTHALPIES = str(DATA / "chem" / "Species_enthalpy.dat")
