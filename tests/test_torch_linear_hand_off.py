"""Port parity: the chemistry hand-off with the linear gas-dust couple
(dust_gas_linear_couple), on the CPU.

As tests/test_torch_exchange_hand_off.py, with the gas-grain temperature
difference damped by the dust emission's response (its slope from the
Tdust LUT) instead of the tandem re-solve: the coupled pool sweep of 4
cells through a window of 2 to 1e-2 yr in both packages, held to the
bars of tests/test_torch_run.py's check_hand_off.
"""

from test_torch_run import check_hand_off
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)


def test_linear_couple_hand_off_matches_jax():
    check_hand_off("one", 2, 1e-2, hc=dict(dust_gas_linear_couple=True))
