"""``build_ms.filter``: the counter's build, ms — the benchmark's span
around ``engine.make_parent_filter_counter`` (the table's upload, K11,
the prefix directory, the accumulator), ending in a sync."""

# a state of a run and what it reads there (the tests' example)
EXAMPLE = ({"spans": {"build": [0.5]}}, 500.0)


def read(run):
    spans = run["spans"].get("build")
    return spans[0] * 1e3 if spans else None
