"""Seconds from the start of the process to the start of the window:
imports, the model's preparation, kernel builds (first run of a
checkout only), the set-up MC passes and the warm-up."""


def read(run):
    return run.setup_s
