"""cuFFT device milliseconds per registration (``layers/fft/``)."""


def read(run):
    if run.trace is None or not run.solves:
        return None
    t = run.trace.seconds(run.layers["fft"]["kernels"])
    return 1e3 * t / len(run.solves) if t > 0 else None
