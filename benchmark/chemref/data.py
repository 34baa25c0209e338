"""Where the reference reads the shipped data files: in the JAX
package's data directory, by path (nothing of that package is
imported)."""

import pathlib

DATA = pathlib.Path(__file__).resolve().parents[2] / "rac2d_tpu" / "data"
