"""ms of one fixed-temperature BDF round: the sweeps' time less their
fields' time and less the equilibrium-T solve's (the self time of
chem.eqT, chem.eqT.eval and chem.eqT.read), over their rounds (the
untraced sweeps of the window).  The equilibrium-T windows' environment
assembly (chem.envs) stays in it.  None where the tables hold chem.eqT
without chem.eqT.eval (harness/eqt_spans.py)."""

from harness import eqt_spans


def read(run):
    w = eqt_spans.window(run)
    if w is None:
        return None
    t = run.record["timed"]
    eqt = eqt_spans.seconds(w, *eqt_spans.NAMES)
    return 1e3 * (t["wall_s"] - t["fields_s"] - eqt) / t["rounds"]
