"""Device ms per step of the operations launched inside the port's own
``render.mesh.rasterize.interpolate.backward`` spans: the backward of the
re-gather of the winners' vertices and features and their barycentric
interpolation, whose scatter-add shares its kernel's name with the
texture's."""

from portbench import program_trace


def read(run):
    return program_trace.device_ms(
        run, "render.mesh.rasterize.interpolate.backward")
