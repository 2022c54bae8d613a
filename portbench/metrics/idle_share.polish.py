"""The device's idle share of the traced polish window: 1 - the union of
the float64 kernels' CUDA-event intervals over the window's host-clock
seconds, in %.  Moves ``polish_evals_per_s``; layer: the device."""


def read(ctx):
    if ctx.get("kind") != "polish" or "event_device_s" not in ctx:
        return None
    return 100.0 * (1.0 - ctx["event_device_s"] / ctx["window_s"])
