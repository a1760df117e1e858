"""``dedup_keep_share.stages``: the share of the window's k-windows that
the dedup leaves the tally to probe, %: the port's counter
``filter.distinct_keys`` (K9d's or K9dw's per-segment counts, summed on
the card) over ``filter.windows`` (the valid windows of the batches
fed), both counted over the traced window (``portbench.program_spans``'
``dedup_keep_share`` reading)."""

# a state of a run and what it reads there (the tests' example)
EXAMPLE = ({"work": {"filter.windows": 3932160,
                     "filter.distinct_keys": 524288}}, 13.333333333333334)


def read(run):
    windows = run["work"].get("filter.windows")
    distinct = run["work"].get("filter.distinct_keys")
    if not windows or distinct is None:
        return None
    return distinct / windows * 100
