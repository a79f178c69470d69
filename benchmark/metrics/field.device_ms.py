"""``field.device_ms``: device time a step of what the field's evaluations
and Euler chain launched and of their backward, ms, over the traced
round."""


def read(run):
    t = run.trace
    if not t or not t["layer_s"].get("field"):
        return None
    return 1e3 * t["layer_s"]["field"] / len(t["gaps"])
