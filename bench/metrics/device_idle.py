"""device_idle: the share of the traced window in which no kernel, copy
or set of the program ran on the device, in percent.  The idle time the
benchmark's own routing made (``bench.route``: its kernels, and the gaps
while the host was inside it) is left out of the window."""


def read(run):
    if run.trace is None:
        return None
    window = run.trace.window_s - run.trace.own_s
    if window <= 0:
        return None
    return (1 - run.trace.busy_s / window) * 100
