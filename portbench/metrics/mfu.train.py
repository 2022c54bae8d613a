"""The whole train step's share of the card's peak: the least time of the
window's chunks (``bounds.train_least``: sweeps, E and H psi of every
step and the chunk's extra forward pass) over the window's host-clock
seconds, in %.  Moves ``train_steps_per_s``; layer: the whole step."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("chunks") or "busy_s" not in ctx:
        return None
    return 100.0 * ctx["chunk_least_s"] * ctx["chunks"] / ctx["window_s"]
