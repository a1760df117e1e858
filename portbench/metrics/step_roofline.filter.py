"""``step_roofline.filter``: the step's share of its bandwidth roofline, %.

The least bytes the window's steps need, over the card's peak bandwidth,
divided by the summed device time of every kernel the window ran (copies
and fills excluded; the profiler's timeline).  The least bytes of a batch
fed are its codes and lengths, one 32-byte sector of table for each
distinct canonical key of the batch and 16 bytes of accumulator, read
and written, for each distinct table row it hits (counted by the plain
reference), whatever implements the step."""

# a state of a run and what it reads there (the tests' example)
EXAMPLE = ({"trace": {"kernel_s": 2.0},
            "work": {"least_bytes": 3.35e12},
            "peaks": {"hbm_bytes_per_s": 3.35e12}}, 50.0)


def read(run):
    trace, peaks = run["trace"], run["peaks"]
    least = run["work"].get("least_bytes")
    if not trace or not peaks or not least or trace["kernel_s"] <= 0:
        return None
    return least / peaks["hbm_bytes_per_s"] / trace["kernel_s"] * 100
