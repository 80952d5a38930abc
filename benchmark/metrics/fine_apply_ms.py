"""Device milliseconds of one fine-operator apply: the kernels inside the
``bench.fine_apply`` scope of the traced step over its calls."""


def read(run):
    if run.trace is None:
        return None
    device_s, calls = run.trace["scopes"].get("bench.fine_apply", (0.0, 0))
    if not calls or device_s <= 0:
        return None
    return 1e3 * device_s / calls
