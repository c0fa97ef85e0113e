"""Device ms per frame of the operations launched inside the port's own
``physics.simplicits.step`` spans in the contact stack: the detection and
Newton graphs' replays (their kernels carry the replays' launches), the
state's copies in and out and the read after the replays."""

from portbench import program_trace


def read(run):
    return program_trace.device_ms(run, "physics.simplicits.step")
