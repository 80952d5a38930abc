"""The least time of one apply's work over the device time an apply took,
in %.  The work is counted from the configuration's problem
(``harness/work.py``: cells, degree, Gauss points, flavor), for an affine
lattice; the device time is that of every device operation inside the
``bench.apply`` scopes of the traced stretch, whatever its name, over
the applies (the chain's normalization between applies is left out)."""

from benchmark.harness.work import lattice_apply_work, least_time_s


def read(run):
    if run.trace is None or run.config.get("system") != "lattice_operator":
        return None
    device_s, calls = run.trace["scopes"].get("bench.apply", (0.0, 0))
    if not calls or device_s <= 0:
        return None
    p = run.config["program"]
    n = 2 ** p["n_global_refinements"]
    nbytes, flops = lattice_apply_work(
        p["dim"], (n,) * p["dim"], p["fe_degree"], p["fe_degree"] + 1,
        p["flavor"], p["consider_time_derivative"],
        p["cell_wise_stabilization"])
    return 100.0 * least_time_s(nbytes, flops)[0] / (device_s / calls)
