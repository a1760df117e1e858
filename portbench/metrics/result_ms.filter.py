"""``result_ms.filter``: ``FilteredCounter.result()``, ms — the benchmark's
span around the one call a scan makes, the accumulator's copy back,
ending in a sync."""

# a state of a run and what it reads there (the tests' example)
EXAMPLE = ({"spans": {"result": [0.25]}}, 250.0)


def read(run):
    spans = run["spans"].get("result")
    return spans[0] * 1e3 if spans else None
