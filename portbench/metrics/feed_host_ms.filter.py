"""``feed_host_ms.filter``: the mean host time of a ``FilteredCounter.feed``
call in the window, ms — the benchmark's span around each call, which
holds the blocking pageable copy up and the kernels' launches."""

# a state of a run and what it reads there (the tests' example)
EXAMPLE = ({"spans": {"feed": [0.001, 0.003]}}, 2.0)


def read(run):
    spans = run["spans"].get("feed")
    return sum(spans) / len(spans) * 1e3 if spans else None
