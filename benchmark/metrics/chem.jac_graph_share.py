"""Share of the window's Jacobian refreshes (entries of the span
chem.jac) that the program replayed from the Jacobian's CUDA graph
(entries of the marker span chem.jac.graph, entered inside chem.jac on
each replay), in %, over the window's untraced sweeps.  None where the
program has no graphed Jacobian (no rac2d_torch.ops.odesys.JAC_GRAPHS)
or the tables do not match the window."""

from harness import chem_spans


def read(run):
    try:
        from rac2d_torch.ops.odesys import JAC_GRAPHS  # noqa: F401
    except ImportError:
        return None
    w = chem_spans.window(run)
    if w is None or not w.get("chem.jac", (0.0, 0))[1]:
        return None
    return 100.0 * w.get("chem.jac.graph", (0.0, 0))[1] / w["chem.jac"][1]
