"""``device_idle_share.filter``: the share of the traced window in which
the card runs neither a kernel nor a copy, %.  Busy time and the window
both come from one ``torch.profiler`` timeline."""

# a state of a run and what it reads there (the tests' example)
EXAMPLE = ({"trace": {"window_s": 10.0, "busy_s": 6.0}}, 40.0)


def read(run):
    trace = run["trace"]
    if not trace or trace["window_s"] <= 0:
        return None
    return (1 - trace["busy_s"] / trace["window_s"]) * 100
