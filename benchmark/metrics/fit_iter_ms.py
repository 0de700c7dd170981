"""Milliseconds per Adam iteration of the window's fits: their seconds over
their iterations, from the program's `phase_timings`."""


def read(record: dict):
    iters = sum(f["n_iters"] for f in record["fits"])
    return 1e3 * sum(f["sec"] for f in record["fits"]) / iters if iters else None
