"""Device ms per step of the operations launched inside the port's own
``render.mesh.texture_mapping.backward`` spans (autograd's engine thread,
from the texture's output gradient to its inputs' gradients): the
texture's four gathers' backward, the scatter-adds into the expanded
texture, and their elementwise work."""

from portbench import program_trace


def read(run):
    return program_trace.device_ms(run, "render.mesh.texture_mapping.backward")
