"""Port parity: the chemistry hand-off with evolT=False, on the CPU.

tests/test_torch_run.py's tiny model cut to one column (4 active cells),
the JAX package's run_mc state carried into the port
(convert.model_state), then chemistry_step(1) in both: the pool sweep at
fixed T through a window of 2 to 1e-2 yr, then the equilibrium T
(thermal.solve_equilibrium_T) in windows of 2 cells, as the JAX package
makes it.  The bars of tests/test_torch_run.py: the same failed cells,
quality and converged mask, key species within 5% where |X| > 1e-12,
Tgas within 2%, and some abundance above 1e-12 moved by more than 10%
(the fixed-T sweep did work).  About a minute of it is the JAX sweep's
compile.
"""

from test_torch_run import check_hand_off
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)


def test_chemistry_hand_off_evolT_false_matches_jax():
    check_hand_off("one", 2, 1e-2, evolT=False)
