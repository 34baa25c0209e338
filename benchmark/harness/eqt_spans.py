"""The equilibrium gas temperature's spans over the window's untraced
sweeps, for the per-layer metrics of the fixed-temperature (evolT=False)
cell.

DiskModel._equilibrium_T is the span chem.eqT; inside it each evaluation
of the net heating in ThermalBalance.solve_equilibrium_T is chem.eqT.eval
and each read back of its loops' tests chem.eqT.read.  Its windows'
environment assembly is chem.envs, which none of these counts.  The
tables are harness/chem_spans.py's.  None where they hold chem.eqT but
no entry of chem.eqT.eval: a program without the solve's spans.  A
window with no equilibrium-T solve at all (a coupled cell: no chem.eqT)
reads no time and no evaluations in it.
"""

from harness import chem_spans

NAMES = ("chem.eqT", "chem.eqT.eval", "chem.eqT.read")


def window(run):
    """chem_spans.window(run), or None where it holds chem.eqT without
    an entry of chem.eqT.eval."""
    w = chem_spans.window(run)
    if w is None or ("chem.eqT" in w
                     and not w.get("chem.eqT.eval", (0.0, 0))[1]):
        return None
    return w


def seconds(w, *names):
    """The spans' self seconds in the table w."""
    return sum(w.get(n, (0.0, 0))[0] for n in names)


def ms_per_sweep(run, *names):
    """The spans' self time, in ms per sweep of the window."""
    w = window(run)
    if w is None:
        return None
    return 1e3 * seconds(w, *names) / run.record["timed"]["sweeps"]
