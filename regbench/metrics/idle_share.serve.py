"""The device's idle share of the traced window, in %: 1 - busy / window."""


def read(run):
    if run.trace is None or not run.requests or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
