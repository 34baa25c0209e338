"""Share of the window's Newton right-hand sides (entries of the span
chem.rhs) that the program replayed from the RHS's CUDA graph (entries
of the marker span chem.rhs.graph, entered inside chem.rhs on each
replay), in %, over the window's untraced sweeps.  None where the
program has no graphed RHS (no rac2d_torch.ops.odesys.RHS_GRAPHS) or
the tables do not match the window."""

from harness import chem_spans


def read(run):
    try:
        from rac2d_torch.ops.odesys import RHS_GRAPHS  # noqa: F401
    except ImportError:
        return None
    w = chem_spans.window(run)
    if w is None or not w.get("chem.rhs", (0.0, 0))[1]:
        return None
    return 100.0 * w.get("chem.rhs.graph", (0.0, 0))[1] / w["chem.rhs"][1]
