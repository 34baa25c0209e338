"""Port parity: the chemistry hand-off with the tandem Tdust re-solve
(allow_gas_dust_en_exch and tdust_iter_tandem), on the CPU.

tests/test_torch_run.py's tiny model cut to one column (4 active cells):
both packages prepare it, so each rebuilds its ThermalBalance with the
Tdust(energy) LUT of its optics tables; the JAX package's run_mc state is
carried into the port (convert.model_state), then chemistry_step(1) in
both: the coupled (evolT=True) pool sweep through a window of 2 to 1e-2
yr, every right-hand side re-solving each dust component's temperature
with the gas-collision energy included.  The bars of check_hand_off: the
same failed cells, quality and converged mask, key species within 5%
where |X| > 1e-12, Tgas within 2%, and some abundance above 1e-12 moved
by more than 10%.
"""

from test_torch_run import check_hand_off
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)


def test_tandem_exchange_hand_off_matches_jax():
    check_hand_off("one", 2, 1e-2, hc=dict(allow_gas_dust_en_exch=True,
                                           tdust_iter_tandem=True))
