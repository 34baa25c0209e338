"""ms a sweep of host self time in the equilibrium gas temperature
(evolT=False): the spans chem.eqT, chem.eqT.eval and chem.eqT.read, its
net-heating evaluations, its loop tests' reads and the rest of
DiskModel._equilibrium_T (its windows' environment assembly is
chem.envs, not counted), over the window's untraced sweeps.  None where
the tables hold chem.eqT without chem.eqT.eval (harness/eqt_spans.py)."""

from harness import eqt_spans


def read(run):
    return eqt_spans.ms_per_sweep(run, *eqt_spans.NAMES)
