"""``dedup_roofline.stages``: the dedup stage's share of its bandwidth
roofline, %: the least bytes of the batches fed (every window slot's key
in; each distinct key of an 8,192-slot segment with its multiplicity and
each segment's count out; counted by the plain reference,
:mod:`portbench.reference.filter_stages`) over the card's peak bandwidth,
divided by the traced window's device time of K9d (``seg_dedup_kernel``)
or K9dw (``seg_dedup_wide_kernel``)."""

from portbench.reference.filter_stages import stage_roofline

KERNELS = ("seg_dedup_kernel", "seg_dedup_wide_kernel")
# a state of a run and what it reads there (the tests' example)
EXAMPLE = ({"trace": {"device_ops": [
               ["void (anonymous namespace)::seg_dedup_wide_kernel<3>"
                "(long long const*, long long, long long*)", 1.0],
               ["void (anonymous namespace)::extract_wide_kernel<3>"
                "(unsigned char const*)", 1.0]]},
            "work": {"dedup_bytes": 6.7e11},
            "peaks": {"hbm_bytes_per_s": 3.35e12}}, 20.0)


def read(run):
    return stage_roofline(run, "dedup", KERNELS)
