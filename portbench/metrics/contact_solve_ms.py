"""Device ms per frame of Newton's dense factorisations and triangular
solves in the contact stack (the contact graph's Cholesky and LU), by the
frozen names of ``portbench/roofline/simplicits_names.json``."""

from portbench.roofline import simplicits


def read(run):
    if run.trace is None:
        return None
    ms = simplicits.solve_ms(run.trace)
    return ms if ms > 0 else None
