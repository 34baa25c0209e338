"""Port parity: the chunked sweep (chem_stream=False) with evolT=False, on
the CPU.

As tests/test_torch_chunked_hand_off.py at fixed T: each chunk of 3
cells is solved by the record driver to 1e-2 yr with the rate vectors
computed once per lane, then the equilibrium T of the chunk's real cells
by bisection (thermal.solve_equilibrium_T), a cell taking it where it was
both bracketed and solved.  Held to the bars of
tests/test_torch_run.py's check_hand_off.
"""

from test_torch_run import check_hand_off
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)


def test_chunked_evolT_false_hand_off_matches_jax():
    check_hand_off("one", 3, 1e-2, chem_stream=False, evolT=False)
