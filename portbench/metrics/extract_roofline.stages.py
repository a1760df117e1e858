"""``extract_roofline.stages``: the extract stage's share of its bandwidth
roofline, %: the least bytes of the batches fed (codes and lengths in, a
key of 8C bytes out for every window slot; counted by the plain
reference, :mod:`portbench.reference.filter_stages`) over the card's peak
bandwidth, divided by the traced window's device time of K1
(``extract_canonical_kernel``) or K1w (``extract_wide_kernel``)."""

from portbench.reference.filter_stages import stage_roofline

KERNELS = ("extract_canonical_kernel", "extract_wide_kernel")
# a state of a run and what it reads there (the tests' example)
EXAMPLE = ({"trace": {"device_ops": [
               ["void (anonymous namespace)::extract_canonical_kernel<5>"
                "(unsigned char const*, int const*, long, int, long*)", 0.5],
               ["Memcpy HtoD (Pinned -> Device)", 3.0]]},
            "work": {"extract_bytes": 3.35e11},
            "peaks": {"hbm_bytes_per_s": 3.35e12}}, 20.0)


def read(run):
    return stage_roofline(run, "extract", KERNELS)
