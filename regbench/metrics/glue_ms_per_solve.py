"""Device milliseconds per registration of the operations that none of the
layers below names: PyTorch's elementwise kernels, copies, reductions and
sets around the hand-written kernels and cuFFT. The list is fixed here, so
a layer added later does not change what this metric counts."""

#: the layers (``layers/<name>/``) whose kernels are not glue
NOT_GLUE = ("interp", "fd8", "prefilter", "fft")


def read(run):
    if run.trace is None or not run.solves:
        return None
    named = [p for layer in NOT_GLUE for p in run.layers[layer]["kernels"]]
    total = sum(run.trace.by_name.values())
    return 1e3 * (total - run.trace.seconds(named)) / len(run.solves)
