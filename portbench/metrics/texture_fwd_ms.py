"""Device ms per step of the operations launched inside the benchmark's
``texture_fwd`` spans (the host call in the span, on any thread)."""


def read(run):
    if run.trace is None or "texture_fwd" not in run.trace.spans:
        return None
    ms = 1e3 * run.trace.span_device_s("texture_fwd")
    return ms if ms > 0 else None
