"""``device.idle_share``: the share of the traced stretch (from the first
loop span to the last device event) in which no kernel, copy or memset
ran, %."""


def read(run):
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
