"""Port parity: the chunked sweep (chem_stream=False) with evolT=True, on
the CPU.

tests/test_torch_run.py's tiny model cut to one column (4 active cells),
the JAX package's run_mc state carried into the port, then
chemistry_step(1) in both through the chunked sweep: chunks of 3 cells
(the second holds one real cell, padded by repeating it), each solved by
the record driver (a barrier at every output time) to 1e-2 yr, the cells
still failing re-solved at the next tolerance level.  The chunks hold the
same cells in both packages; check_hand_off prints the worst key-species
difference and holds the hand-off to its bars (the same failed cells,
quality and converged mask, key species within 5% where |X| > 1e-12,
Tgas within 2%, some abundance above 1e-12 moved by more than 10%).
The tolerance ladder's d2g is the mean over the active cells in the port
and over every cell in the JAX package (ROADMAP.md section 3).
"""

from test_torch_run import check_hand_off
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)


def test_chunked_hand_off_matches_jax():
    check_hand_off("one", 3, 1e-2, chem_stream=False)
