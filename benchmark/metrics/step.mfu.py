"""``step.mfu``: the window's model FLOPs at the card's peaks over the
window's time, %: for each step, the depth net's convolutions (forward,
data and weight gradients) over the peak of the depth net's type and the
field's evaluations (forward and backward) over the float32-operand peak,
summed, over the window's wall time."""


def read(run):
    if not run.records or run.window_s <= 0:
        return None
    least = sum(run.step_least_seconds(r["gap"]) for r in run.records)
    return 100.0 * least / run.window_s
