"""Device kernels a train step launches: the kernels in the traced window
(CUDA-graph replays included; copies and sets left out) over its steps.
Moves ``train_steps_per_s``; layer: the fused runner."""


def read(ctx):
    if ctx.get("kind") != "train" or "n_kernels" not in ctx or not ctx["steps"]:
        return None
    return ctx["n_kernels"] / ctx["steps"]
