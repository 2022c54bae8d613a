"""The whole evaluation's share of the card's float64 peak: the least time
of the window's evaluations over its host-clock seconds, in %.  Moves
``polish_evals_per_s``; layer: the whole evaluation."""


def read(ctx):
    if ctx.get("kind") != "polish" or not ctx.get("evals") or "event_device_s" not in ctx:
        return None
    return 100.0 * ctx["eval_least_s"] * ctx["evals"] / ctx["window_s"]
