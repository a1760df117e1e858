# Copied from kmer_denovo_filter_tpu/kmer.py
"""Host-side k-mer semantics (exact-parity oracle for the device engine).

These pure functions define the bit-exact semantics the TPU engine must
reproduce: canonicalization, sliding-window extraction with N
filtering, variant-spanning extraction with the base-quality window,
and the strict alt-allele support check.  They mirror the behaviour of
reference kmer_utils.py:30–121 and :1037–1172 and serve as the oracle
in tests; the pipelines use them only on the tiny targeted-fetch paths
(per-variant reads), never on whole-genome streams.
"""

_COMP_TABLE = str.maketrans("ACGTacgt", "TGCAtgca")


def is_symbolic(allele):
    """True for symbolic VCF alleles (<DEL>, breakends, '*', empty).

    Mirrors reference kmer_utils.py:18–27.
    """
    if not allele:
        return True
    return allele[0] == "<" or allele == "*" or "[" in allele or "]" in allele


def reverse_complement(seq):
    """Reverse complement of a DNA string."""
    return seq.translate(_COMP_TABLE)[::-1]


def canonicalize(kmer):
    """Lexicographically smaller of the k-mer and its reverse complement."""
    rc = kmer.translate(_COMP_TABLE)[::-1]
    return kmer if kmer < rc else rc


def extract_read_kmers(seq, kmer_size):
    """Canonical k-mers of a read by sliding window, skipping windows with N.

    Returns ``(canon_at_pos, unique_candidates)`` where *canon_at_pos*
    maps query start index → canonical k-mer and *unique_candidates*
    preserves first-seen order (reference kmer_utils.py:91–121).
    """
    n = len(seq)
    if n < kmer_size:
        return {}, []
    seq_u = seq.upper()
    canon_at_pos = {}
    ordered = []
    seen = set()
    for i in range(n - kmer_size + 1):
        kmer = seq_u[i:i + kmer_size]
        if "N" in kmer:
            continue
        canon = canonicalize(kmer)
        canon_at_pos[i] = canon
        if canon not in seen:
            seen.add(canon)
            ordered.append(canon)
    return canon_at_pos, ordered


def read_supports_alt(read, variant_pos, ref, alt, min_baseq=0, *,
                      aligned_pairs=None, seq=None, quals=None):
    """True when *read* carries exactly the alternate allele at the locus.

    Walks the aligned pairs across the reference span of the variant
    and compares the gathered read bases to *alt* (handles SNP/MNP/
    ins/del/complex).  Any sub-threshold base quality inside the span
    fails the check.  Mirrors reference kmer_utils.py:1037–1099.
    """
    if alt is None or is_symbolic(alt):
        return False
    if seq is None:
        seq = read.query_sequence
    if seq is None:
        return False
    if min_baseq > 0 and quals is None:
        quals = read.query_qualities
    if aligned_pairs is None:
        aligned_pairs = read.get_aligned_pairs(matches_only=False)

    gathered = []
    inside = False
    for qpos, rpos in aligned_pairs:
        if rpos is not None and rpos >= variant_pos + len(ref):
            break
        if rpos == variant_pos:
            inside = True
        if inside and qpos is not None:
            if min_baseq > 0 and quals is not None and quals[qpos] < min_baseq:
                return False
            gathered.append(seq[qpos])
    if not inside:
        return False
    return "".join(gathered).upper() == alt.upper()


def extract_variant_spanning_kmers(read, variant_pos, k, min_baseq=0,
                                   ref=None, alt=None, *,
                                   aligned_pairs=None, seq=None, quals=None):
    """Canonical k-mers of *read* whose window covers the variant locus.

    The window is widened to the right for insertions so k-mers
    spanning the right junction are captured; windows containing an N
    or a sub-threshold base quality are rejected via a sliding bad-base
    counter.  Mirrors reference kmer_utils.py:1102–1172.
    """
    del aligned_pairs  # API compatibility
    try:
        read_pos_at_variant = read.get_reference_positions(
            full_length=True).index(variant_pos)
    except ValueError:
        return set()

    if seq is None:
        seq = read.query_sequence
    if seq is None:
        return set()
    if quals is None:
        quals = read.query_qualities

    alt_len = len(alt) if alt and not is_symbolic(alt) else 1
    variant_end_in_read = read_pos_at_variant + alt_len - 1

    kmers = set()
    start_min = max(0, read_pos_at_variant - k + 1)
    start_max = min(len(seq) - k, variant_end_in_read)

    window_end = start_max + k
    window = seq[start_min:window_end].upper()
    bad = bytearray(len(window))
    for i, ch in enumerate(window):
        if ch == "N":
            bad[i] = 1
    if quals is not None and min_baseq > 0:
        for i in range(window_end - start_min):
            if quals[start_min + i] < min_baseq:
                bad[i] = 1

    bad_count = sum(bad[:min(k, len(bad))])
    for s in range(start_min, start_max + 1):
        off = s - start_min
        if off > 0:
            bad_count -= bad[off - 1]
            bad_count += bad[off + k - 1]
        if bad_count:
            continue
        kmers.add(canonicalize(seq[s:s + k]))
    return kmers


def ref_sequence_kmers(seq, kmer_size):
    """Canonical k-mer set of a reference contig (N windows skipped)."""
    out = set()
    seq_u = seq.upper()
    for i in range(len(seq_u) - kmer_size + 1):
        kmer = seq_u[i:i + kmer_size]
        if "N" in kmer:
            continue
        out.add(canonicalize(kmer))
    return out
