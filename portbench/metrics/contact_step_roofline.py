"""A contact step's share of its roofline: the frozen bound of one step
(``portbench/roofline/simplicits_contact.py``) at the live pairs and
Newton iterations the traced window counted a frame (the port's counters
``physics.collision.contacts`` and ``physics.simplicits.newton_iterations``)
over the device ms a frame inside the port's ``physics.simplicits.step``
spans, %."""

from portbench import program_trace
from portbench.roofline import simplicits_contact

CONTACTS = "physics.collision.contacts"
ITERATIONS = "newton_iterations"


def read(run):
    ms = program_trace.device_ms(run, "physics.simplicits.step")
    counts = program_trace.counters(run)
    if ms is None or counts is None or not counts.get(CONTACTS) \
            or len(run.geometry) < 2:
        return None
    before, after = run.geometry[0], run.geometry[-1]
    iterations = after.get(ITERATIONS, 0) - before.get(ITERATIONS, 0)
    if iterations <= 0:
        return None
    bound = simplicits_contact.bound_ms(
        run.cfg, counts[CONTACTS] / run.steps, iterations / run.steps,
        after["occupied_cells"], after["cell_capacity"])
    return 100.0 * bound / ms
