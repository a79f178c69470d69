"""``loop.gap_ms``: the mean device-clock gap between one step's end and
the next step's start, ms, over the window: ``interval - seconds`` of the
loop's CUDA-event records (the epoch's first step has no previous end)."""


def read(run):
    recs = run.records[1:]
    if not recs:
        return None
    return 1e3 * sum(r["interval"] - r["seconds"] for r in recs) / len(recs)
