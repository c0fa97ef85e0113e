"""The share of the contact buffer's slots that held a live pair, %: the
live pairs the traced window's detections found (the port's device counter
``physics.collision.contacts``) over the frames times the buffer's
capacity, which sets how many pairs every per-contact term of a step
runs over."""

from portbench import program_trace

CONTACTS = "physics.collision.contacts"


def read(run):
    counts = program_trace.counters(run)
    if counts is None or not counts.get(CONTACTS) or not run.geometry:
        return None
    capacity = run.geometry[-1].get("contact_capacity")
    if not capacity:
        return None
    return 100.0 * counts[CONTACTS] / (run.steps * capacity)
