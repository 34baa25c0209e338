"""Per sweep, the driver's own timers of the fields that feed the
chemistry: columns and shielding (DiskModel._t_shield, ended by a
synchronize) and the environments' assembly (_t_envs), in ms; the mean
over the window's untraced sweeps."""


def read(run):
    t = run.record["timed"]
    return 1e3 * t["fields_s"] / t["sweeps"]
