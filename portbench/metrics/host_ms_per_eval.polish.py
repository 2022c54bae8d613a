"""Host milliseconds an L-BFGS-B evaluation adds to its kernels: the
window's milliseconds an evaluation less the CUDA-event device
milliseconds of its float64 kernels (the profiler does not see their
cooperative launches).  Moves ``polish_evals_per_s``; layer: the polish
driver (scipy and the host side of ``native/statevec.py``)."""


def read(ctx):
    if ctx.get("kind") != "polish" or "event_device_s" not in ctx or not ctx["evals"]:
        return None
    return 1e3 * (ctx["window_s"] - ctx["event_device_s"]) / ctx["evals"]
