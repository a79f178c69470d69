"""``depth_net.roofline``: the depth net's least time (its convolutions'
FLOPs over the peak of its type, or their bytes over 3.35 TB/s, the larger)
over its device time in the traced round, %."""

from benchmark import workcount


def read(run):
    t = run.trace
    if not t or not t["layer_s"].get("depth_net"):
        return None
    least = workcount.least_seconds(run.depth_work, run.precision)
    return 100.0 * least * len(t["gaps"]) / t["layer_s"]["depth_net"]
