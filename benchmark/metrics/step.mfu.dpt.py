"""``step.mfu.dpt``: ``step.mfu`` with the DPT's whole work: each step's
depth-net FLOPs (``dptcount``'s count added to the convolutions') over the
peak of its type and the field's over the float32-operand peak, summed,
over the window's wall time, %."""

from benchmark import dptcount, workcount


def read(run):
    if not run.records or run.window_s <= 0:
        return None
    work = dptcount.full_depth_work(run)
    if work is None:
        return None
    rest = (work["flops"] - run.depth_work["flops"]) \
        / workcount.PEAK_FLOPS[run.precision]
    least = sum(run.step_least_seconds(r["gap"]) + rest for r in run.records)
    return 100.0 * least / run.window_s
