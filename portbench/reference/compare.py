"""Measures that a fit's comparison (``NUMBERS`` and ``numbers`` of
``portbench.reference.<fit>_fit``) is built from, and the verdict."""

import statistics

import torch


def norms(tree):
    """{leaf: its float64 norm}."""
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def rel(a, b):
    """|a − b| / |b|."""
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-30)


def leaf_gaps(prog, ref):
    """Each leaf's gap between the program's norm and the reference's, over
    the larger of the reference's norm of that leaf and of the median
    leaf."""
    floor = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], floor) for k in ref}


def finite(*trees):
    """Whether every tensor in the dicts ``trees`` is finite."""
    return all(bool(torch.isfinite(t).all()) for tree in trees
               for t in tree.values())


def judge(values, limits):
    """(correct, [(name, value, limit)]) in the order of ``values``:
    correct where every number is at or under its limit (a nan is not)."""
    if set(values) != set(limits):
        raise ValueError(f"numbers {sorted(values)} against limits "
                         f"{sorted(limits)}")
    rows = [(k, v, limits[k]) for k, v in values.items()]
    return all(v <= lim for _, v, lim in rows), rows
