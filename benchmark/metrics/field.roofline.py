"""``field.roofline``: the field's least time (its evaluations' FLOPs,
forward and backward, over the float32-operand peak, or their bytes over
3.35 TB/s, the larger, summed over the traced steps' gaps) over its device
time in the traced round, %."""

from benchmark import workcount


def read(run):
    t = run.trace
    if not t or not t["layer_s"].get("field"):
        return None
    least = sum(workcount.least_seconds(run.field_work(g), "float32")
                for g in t["gaps"])
    return 100.0 * least / t["layer_s"]["field"]
