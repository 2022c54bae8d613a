"""The device's idle share of the traced train window: 1 - the union of
the profiler's device intervals over the window's host-clock seconds, in
%.  Moves ``train_steps_per_s``; layer: the device."""


def read(ctx):
    if ctx.get("kind") != "train" or "busy_s" not in ctx:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
