"""Ms per step in which the device ran nothing while the host was inside
the port's own ``render.mesh.dibr_rasterization`` spans: the idle time
the wrapper's host work leaves the card."""

from portbench import program_trace


def read(run):
    return program_trace.idle_ms(run, "render.mesh.dibr_rasterization")
