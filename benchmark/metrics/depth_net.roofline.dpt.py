"""``depth_net.roofline.dpt``: ``depth_net.roofline`` with the DPT's whole
work (its convolutions and ``dptcount``'s dense layers, attention and
transposed convolutions) over its device time in the traced round, %."""

from benchmark import dptcount, workcount


def read(run):
    t = run.trace
    if not t or not t["layer_s"].get("depth_net"):
        return None
    work = dptcount.full_depth_work(run)
    if work is None:
        return None
    least = workcount.least_seconds(work, run.precision)
    return 100.0 * least * len(t["gaps"]) / t["layer_s"]["depth_net"]
