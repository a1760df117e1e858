"""``tally_roofline.stages``: the tally stage's share of its bandwidth
roofline, %: the least bytes of the batches fed (each distinct key of a
segment with its multiplicity in and one 32-byte table sector for it;
16 bytes of accumulator, read and written, for each table row hit;
counted by the plain reference, :mod:`portbench.reference.filter_stages`)
over the card's peak bandwidth, divided by the traced window's device
time of K3 on K9d's slots (``probe_tally_weighted_slots``) or K7
weighted on K9dw's slots (``probe_tally_wide_slots_kernel``)."""

from portbench.reference.filter_stages import stage_roofline

KERNELS = ("probe_tally_weighted_slots", "probe_tally_wide_slots_kernel")
# a state of a run and what it reads there (the tests' example)
EXAMPLE = ({"trace": {"device_ops": [
               ["void (anonymous namespace)::probe_tally_weighted_slots<256>"
                "(long long const*, long long const*, int const*)", 2.0],
               ["void (anonymous namespace)::probe_tally_wide_slots_kernel"
                "<3>(long long const*)", 2.0]]},
            "work": {"tally_bytes": 1.34e12},
            "peaks": {"hbm_bytes_per_s": 3.35e12}}, 10.0)


def read(run):
    return stage_roofline(run, "tally", KERNELS)
