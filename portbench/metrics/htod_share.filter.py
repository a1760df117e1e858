"""``htod_share.filter``: the share of the traced window the card spends
in host-to-device copies, %, from the same timeline."""

# a state of a run and what it reads there (the tests' example)
EXAMPLE = ({"trace": {"window_s": 10.0, "htod_s": 3.0}}, 30.0)


def read(run):
    trace = run["trace"]
    if not trace or trace["window_s"] <= 0 or trace["htod_s"] <= 0:
        return None
    return trace["htod_s"] / trace["window_s"] * 100
