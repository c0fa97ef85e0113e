"""Device ms per frame of the operations launched inside the port's own
``physics.simplicits.detect`` spans: contact detection, replayed from its
own CUDA graph (or run in an eager step), and the live-pair count's add
while tracing."""

from portbench import program_trace


def read(run):
    return program_trace.device_ms(run, "physics.simplicits.detect")
