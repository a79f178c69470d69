"""``pipeline.data_wait_ms``: the host's mean wait for a batch, ms a step,
over the window: the loop's ``data_time`` records (its ``dvd/data_wait``
span)."""


def read(run):
    if not run.records:
        return None
    return 1e3 * sum(r["data_time"] for r in run.records) / len(run.records)
