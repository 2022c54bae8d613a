"""The float64 evaluation's share of its roofline: the least time of the
window's evaluations (``bounds.polish_eval_least``: forward pass, H psi
with E and N, adjoint sweep) over the CUDA-event device time of their
kernels, in %.  Moves ``polish_evals_per_s``; layer: the kernels."""


def read(ctx):
    if ctx.get("kind") != "polish" or not ctx.get("event_device_s"):
        return None
    return 100.0 * ctx["eval_least_s"] * ctx["evals"] / ctx["event_device_s"]
