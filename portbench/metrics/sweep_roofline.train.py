"""The rotation sweeps' share of their roofline: the least time of the
window's forward and adjoint sweeps (``bounds.train_least``: K + 1
forward and K adjoint sweeps a chunk) over the profiler's device time of
the sweep kernels named below.  A kernel renamed or fused away leaves
this None until the list names it.  Moves ``train_steps_per_s``; layer:
the kernels."""

SWEEP_KERNELS = ("rotation_resident_kernel", "adjoint_resident_kernel",
                 "rotation_tile_run_kernel", "adjoint_tile_run_kernel")


def read(ctx):
    if ctx.get("kind") != "train" or "seconds_by_name" not in ctx:
        return None
    busy = sum(s for name, s in ctx["seconds_by_name"].items()
               if any(k in name for k in SWEEP_KERNELS))
    if busy <= 0:
        return None
    return 100.0 * ctx["sweep_least_s"] * ctx["chunks"] / busy
