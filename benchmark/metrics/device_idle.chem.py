"""Share of the traced sweep in which no kernel, copy or memset ran on
the card, in %."""


def read(run):
    tr = run.trace
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
