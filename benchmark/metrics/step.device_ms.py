"""``step.device_ms``: the mean device-clock span of a main step, ms, over
the window: the loop's CUDA events before the step's first launch and after
its last (``seconds``)."""


def read(run):
    if not run.records:
        return None
    return 1e3 * sum(r["seconds"] for r in run.records) / len(run.records)
