"""Discovery pipeline: VCF-free whole-genome proband-unique k-mer scan.

Port of :mod:`kmer_denovo_filter_tpu.discovery.pipeline` with the same
module structure and byte-identical text outputs.  The host code
(clustering, SV linking, writers, summary) is the reference's; the
device work runs through the port's engine on an explicit
``torch.device``:

* Module 0 loads the reference set (``.jf`` / ``.kdx.npz``) or counts
  the FASTA (K1 → device sort-count), into a device or host index;
* Module 1 counts the child (K1 → device sort-count → host merge) and
  subtracts the reference (K4 membership);
* Module 2 filters by the parents: K1 → K9d segment dedup → K3 weighted
  tally on K9d's slots (k > 31: K1w → K9dw → K7 weighted on its slots);
  with 2 or more local cards, a table one card cannot hold (any table
  under ``KDF_SHARDED=1``) shards (:mod:`.parallel.sharded`,
  ``engine._shard_dispatch``);
* Modules 3–4 anchor the proband-unique k-mers in the child reads:
  groups of ``NB_JOIN_MEMBER`` batches, K1 → K4 in one pass per group.

In a multi-host run (``KDF_COORDINATOR``, :mod:`.parallel.multihost`)
every process consumes its own stripe of each BAM: the child counts
merge owner-sharded, the reference subtraction gathers the survivors,
the parent tallies sum, the anchoring scan and the informative-read pass
gather ordinal-keyed snapshots, and process 0 alone writes the outputs
and the reference-index cache.  ``KDF_PROFILE=<dir>`` wraps the run in a
``torch.profiler`` trace (:mod:`..profiling`).  The one change from the
reference: the scan group size is the constant :data:`NB_JOIN_MEMBER`
(no ``KDF_SB_JOIN``).
"""

import bisect
import collections
import json
import logging
import os
import statistics
import time

import numpy as np

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch.parallel import multihost
from kmer_denovo_filter_tpu_torch.profiling import run_profiled
from kmer_denovo_filter_tpu_torch.htsio.bam import (
    BamReader,
    BamWriter,
    read_bam_header,
    stream_records,
)
from kmer_denovo_filter_tpu_torch.htsio.fasta import read_fasta
from kmer_denovo_filter_tpu_torch.htsio.jellyfish import (
    JellyfishParseError,
    load_jf,
)
from kmer_denovo_filter_tpu_torch.kmer import canonicalize
from kmer_denovo_filter_tpu_torch.memory_utils import (
    get_available_memory_gb,
    log_device_memory,
    log_disk_usage,
    log_memory,
)
from kmer_denovo_filter_tpu_torch.ops import encode as enc
from kmer_denovo_filter_tpu_torch.utils import (
    format_elapsed,
    format_file_size,
    is_tmpfs,
    prefetch_batches,
    resolve_tmp_dir,
    validate_inputs,
)

logger = logging.getLogger(__name__)

# Flags excluded from counting scans (samtools fasta -F 0xD00 analog):
# secondary | duplicate | supplementary.
_COUNT_EXCLUDE_FLAGS = 0xD00
# Flags excluded from the anchoring scan (reference scans secondary- and
# duplicate-free but keeps supplementary, core/bam_scanner.py:405–410).
_ANCHOR_EXCLUDE_FLAGS = 0x500

_ANCHOR_BATCH_READS = 4096
# Batches per grouped anchoring scan: one K1 + K4 pass per group (the
# reference's member super-batch window, pallas_join.NB_JOIN_MEMBER).
NB_JOIN_MEMBER = 8


# ── Module 0: reference k-mer index ────────────────────────────────


def ensure_ref_index(ref_fasta, kmer_size, ref_jf=None, *, device):
    """Load or build the reference canonical k-mer set.

    Drop-in acceptance of jellyfish ``binary/sorted`` ``.jf`` files and
    of this tool's own ``.kdx.npz`` cache; otherwise counts the
    reference FASTA on device and caches the result next to it
    (the analog of reference core/jellyfish_wrappers.py:286–332 reuse).

    Returns a :class:`~kmer_denovo_filter_tpu_torch.engine.KmerIndex` on
    *device* (through ``engine.make_membership_index``: on the CPU
    device a table over ``KDF_DEVICE_TABLE_BYTES`` is a host-resident
    :class:`~kmer_denovo_filter_tpu_torch.engine.HostKmerIndex`).
    """
    if ref_jf and os.path.isfile(ref_jf):
        if ref_jf.endswith(".npz"):
            data = np.load(ref_jf)
            if "k" in data and int(data["k"]) != kmer_size:
                raise ValueError(
                    f"--ref-jf {ref_jf} was built at k={int(data['k'])} "
                    f"but --kmer-size is {kmer_size}")
            logger.info("Reference k-mer cache found: %s", ref_jf)
            return eng.make_membership_index(
                data["keys"], kmer_size, data["counts"], device=device)
        try:
            keys, counts, k = load_jf(ref_jf, expect_k=kmer_size)
            order = enc.lexsort_keys(keys)
            logger.info("Reference Jellyfish index loaded: %s (%d k-mers)",
                        ref_jf, keys.shape[0])
            return eng.make_membership_index(
                keys[order], kmer_size, counts[order], device=device)
        except JellyfishParseError as e:
            logger.warning(
                "Cannot parse %s (%s); rebuilding reference set from "
                "FASTA", ref_jf, e)

    cache = f"{ref_fasta}.k{kmer_size}.kdx.npz"
    if os.path.isfile(cache):
        if os.path.getmtime(cache) < os.path.getmtime(ref_fasta):
            logger.warning(
                "Reference k-mer cache %s is older than %s; rebuilding",
                cache, ref_fasta)
        else:
            data = np.load(cache)
            if "k" in data and int(data["k"]) != kmer_size:
                raise ValueError(
                    f"reference cache {cache} was built at "
                    f"k={int(data['k'])} but --kmer-size is {kmer_size}")
            logger.info("Reference k-mer cache found: %s", cache)
            return eng.make_membership_index(
                data["keys"], kmer_size, data["counts"], device=device)

    logger.info("Building reference k-mer set: %s (k=%d)",
                ref_fasta, kmer_size)
    build_start = time.monotonic()
    sc = eng.make_stream_counter(kmer_size, device=device)
    for name, seq in read_fasta(ref_fasta).items():
        sc.feed_sequence(seq)
    keys, counts = sc.result()
    # Multi-host runs build the (deterministic) index on every process;
    # only process 0 may write the shared cache file (no write race).
    if multihost.is_primary():
        try:
            # write-then-rename so concurrent readers (other processes
            # of a multi-host run) never see a partial cache
            tmp_cache = f"{cache}.tmp{os.getpid()}"
            np.savez(tmp_cache, keys=keys, counts=counts, k=kmer_size)
            os.replace(tmp_cache if os.path.exists(tmp_cache)
                       else f"{tmp_cache}.npz", cache)
            logger.info("Reference k-mer cache written: %s", cache)
        except OSError:
            pass
    logger.info("Reference set built in %s (%d k-mers)",
                format_elapsed(time.monotonic() - build_start),
                keys.shape[0])
    return eng.make_membership_index(keys, kmer_size, counts,
                                     device=device)


# ── Module 1: child counting & reference subtraction ───────────────


def _extract_child_kmers_discovery(child_bam, kmer_size, min_child_count,
                                   device, stripe=None):
    """Count all child k-mers on device; keep count >= min_child_count.

    Returns ``(candidate_keys, n_candidates)`` — the device analog of
    ``jellyfish count -C`` + ``dump -L min_child_count``
    (reference discovery/pipeline.py:69–268).  With ``stripe=(h, n)``
    each process counts its input shard and the partial (keys, counts)
    merge across processes before thresholding.
    """
    extract_start = time.monotonic()
    logger.info("Extracting child k-mers from BAM (k=%d, device engine)…",
                kmer_size)
    from kmer_denovo_filter_tpu_torch.htsio.bam import packed_batches
    sc = eng.make_stream_counter(kmer_size, device=device)
    n_reads = 0
    for codes, lengths in prefetch_batches(packed_batches(
            child_bam, exclude_flags=_COUNT_EXCLUDE_FLAGS,
            stripe=stripe)):
        sc.feed(codes, lengths)
        n_reads += codes.shape[0]
    keys, counts = sc.result()
    if stripe is not None:
        # owner-sharded merge: this process keeps ONLY its hash shard
        # (O(total/N) per process); the count threshold below then
        # applies shard-locally and only survivors ever gather
        # (multihost.merge_counts_sharded)
        keys, counts = multihost.merge_counts_sharded(keys, counts)
        n_reads = int(multihost.sum_aligned(np.int64(n_reads)))
        n_distinct = int(multihost.sum_aligned(
            np.int64(keys.shape[0])))
    else:
        n_distinct = keys.shape[0]
    logger.info(
        "Child k-mer counting complete (%s, %d reads, %d distinct k-mers)",
        format_elapsed(time.monotonic() - extract_start), n_reads,
        n_distinct)
    log_memory("after child k-mer counting")
    log_device_memory("after child k-mer counting", device)

    keep = counts >= min_child_count
    candidates = keys[keep]
    n_candidates = candidates.shape[0]
    if stripe is not None:
        n_candidates = int(multihost.sum_aligned(
            np.int64(n_candidates)))
    logger.info("Child candidate k-mers (count >= %d): %d",
                min_child_count, n_candidates)
    return candidates, n_candidates


def _subtract_reference_kmers(ref_index, candidate_keys, stripe=None):
    """Keep candidate keys absent from the reference set.

    With ``stripe`` set, *candidate_keys* is this process's owner
    shard: membership applies shard-locally (the replicated reference
    index serves any key subset) and only the surviving non-reference
    sets gather into the identical global sorted array on every process.
    """
    member = ref_index.membership(candidate_keys)
    non_ref = candidate_keys[~member]
    if stripe is not None:
        non_ref = multihost.allgather_keys_sorted(non_ref)
    logger.info("Non-reference child k-mers after subtraction: %d",
                non_ref.shape[0])
    return non_ref, non_ref.shape[0]


# ── Module 2: parent filtering ─────────────────────────────────────


def _count_parent_device(parent_bam, filter_keys, kmer_size, label,
                         device, stripe=None):
    """Filtered parent count (``--if`` analog) on the gated engine.

    Takes host-side *filter_keys*; ``engine.make_parent_filter_counter``
    builds the counter on *device* (host-resident only for a CPU-device
    table over ``KDF_DEVICE_TABLE_BYTES``; sharded over 2 or more local
    cards only when one card cannot hold the table, or under
    ``KDF_SHARDED=1``: ``engine._shard_dispatch``).
    Returns int64 counts aligned with *filter_keys*.  With ``stripe=(h,
    n)`` each process counts its input shard; the aligned partial
    tallies sum across processes.
    """
    scan_start = time.monotonic()
    logger.info("%s: scanning BAM (%s): %s", label,
                format_file_size(parent_bam), parent_bam)
    logger.info("  device filtered count (k=%d, filter_kmers=%d)",
                kmer_size, filter_keys.shape[0])
    from kmer_denovo_filter_tpu_torch.htsio.bam import packed_batches
    fc = eng.make_parent_filter_counter(filter_keys, kmer_size,
                                        device=device)
    n_reads = 0
    for codes, lengths in prefetch_batches(packed_batches(
            parent_bam, exclude_flags=_COUNT_EXCLUDE_FLAGS,
            stripe=stripe)):
        fc.feed(codes, lengths)
        n_reads += codes.shape[0]
    counts = fc.result()
    if stripe is not None:
        counts = multihost.sum_aligned(counts)
        n_reads = int(multihost.sum_aligned(np.int64(n_reads)))
    logger.info("  %s counting complete (%s, %d reads)",
                label, format_elapsed(time.monotonic() - scan_start),
                n_reads)
    return counts


def _filter_parents_discovery(mother_bam, father_bam, non_ref_keys,
                              kmer_size, parent_max_count=0, *, device,
                              stripe=None):
    """Module 2: remove k-mers seen >parent_max_count in either parent.

    Sequential mother-then-father filtering with the reduced survivor
    set, mirroring reference discovery/pipeline.py:462–612.

    Returns ``(n_proband_unique, proband_keys or None)``.
    """
    n_input = non_ref_keys.shape[0]
    if n_input == 0:
        return 0, None
    logger.info("Filtering %d non-reference k-mers against parents…",
                n_input)
    log_memory("before parent filtering")

    mother_counts = _count_parent_device(mother_bam, non_ref_keys,
                                         kmer_size, "Mother", device,
                                         stripe=stripe)
    survive = mother_counts <= parent_max_count
    after_mother = non_ref_keys[survive]
    n_surviving = after_mother.shape[0]
    logger.info(
        "Mother: %d / %d non-ref k-mers found (count > %d), %d surviving",
        n_input - n_surviving, n_input, parent_max_count, n_surviving)
    log_memory("after mother filtering")
    if n_surviving == 0:
        return 0, None

    father_counts = _count_parent_device(father_bam, after_mother,
                                         kmer_size, "Father", device,
                                         stripe=stripe)
    survive = father_counts <= parent_max_count
    proband = after_mother[survive]
    n_proband = proband.shape[0]
    logger.info(
        "Father: %d / %d surviving k-mers found (count > %d), "
        "%d proband-unique",
        n_surviving - n_proband, n_surviving, parent_max_count, n_proband)
    logger.info("Proband-unique k-mers (absent from both parents): %d / %d",
                n_proband, n_input)
    log_memory("after parent filtering")
    return n_proband, proband


# ── Module 3: anchoring & clustering ───────────────────────────────


class _ChildSource:
    """Child-read access for the anchoring scan + informative BAM.

    Small files use the whole-file reader; files above
    ``KDF_STREAM_THRESHOLD_BYTES`` stream with O(buffer) memory
    (WGS BAMs decompress to hundreds of GB).
    """

    def __init__(self, path, ref_fasta=None):
        self.path = path
        threshold = int(os.environ.get(
            "KDF_STREAM_THRESHOLD_BYTES", 1 << 30))
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        self.streaming = size > threshold
        if self.streaming:
            self.header_text, self.refs = read_bam_header(path)
            self._reader = None
        else:
            self._reader = BamReader(path, reference_filename=ref_fasta)
            self.header_text = self._reader.header_text
            self.refs = self._reader.refs

    def records_all(self):
        """Every record in file order (incl. unplaced-unmapped)."""
        if self.streaming:
            return stream_records(self.path)
        return self._reader.fetch(until_eof=True)

    def records_placed(self):
        """Placed records in coordinate order (pysam fetch() analog)."""
        if self.streaming:
            return (r for r in stream_records(self.path) if r.tid >= 0)
        return self._reader.fetch()


def _extract_softclips(cigartuples):
    """Left/right soft-clip lengths (reference core/bam_scanner.py:54–94).

    Hard clips may flank soft clips; a CIGAR whose only non-hard-clip
    op is a soft clip counts it once (left).
    """
    if not cigartuples:
        return (0, 0)
    left = 0
    for op, length in cigartuples:
        if op == 4:
            left = length
            break
        if op == 5:
            continue
        break
    right = 0
    for op, length in reversed(cigartuples):
        if op == 4:
            right = length
            break
        if op == 5:
            continue
        break
    non_hard = [t for t in cigartuples if t[0] != 5]
    if len(non_hard) == 1 and non_hard[0][0] == 4:
        right = 0
    return (left, right)


def _collect_kmer_ref_positions(read, kmer_hit_indices, kmer_size):
    """Map k-mer hit query windows to reference position coverage."""
    cov = collections.Counter()
    query_to_ref = dict(read.get_aligned_pairs(matches_only=True))
    for start_idx in kmer_hit_indices:
        for qpos in range(start_idx, start_idx + kmer_size):
            rpos = query_to_ref.get(qpos)
            if rpos is not None:
                cov[rpos] += 1
    return cov


def _infer_sv_type(region_a, region_b):
    """INTRA for same-chromosome links, BND for translocations."""
    return "BND" if region_a[0] != region_b[0] else "INTRA"


def _read_outcome(read, unique_in_read, kmer_hit_indices, kmer_size):
    """Plain-data snapshot of one informative read.

    Everything region building / SV annotation needs, picklable for
    the multi-host outcome merge (reference core/bam_scanner.py:284–337
    collects the same fields inline).
    """
    out = {"qname": read.query_name, "is_supp": read.is_supplementary,
           "unmapped": read.is_unmapped, "unique": unique_in_read}
    if read.is_unmapped:
        return out
    out["chrom"] = read.reference_name
    out["start"] = read.reference_start
    out["end"] = read.reference_end
    out["cov"] = _collect_kmer_ref_positions(read, kmer_hit_indices,
                                             kmer_size)
    # SV evidence snapshot: SA string kept on primary records only
    # (supplementary SA tags point back at the primary), mate status
    # meaningful only for paired reads, clip = longest softclip op.
    has_sa = read.has_tag("SA")
    meta = {"has_sa": has_sa, "sa_str": None,
            "is_paired": read.is_paired,
            "is_proper_pair": read.is_proper_pair,
            "mate_is_unmapped": False,
            "max_clip": max((length for op, length
                             in (read.cigartuples or ()) if op == 4),
                            default=0)}
    if has_sa and not read.is_supplementary:
        meta["sa_str"] = read.get_tag("SA")
    if read.is_paired:
        meta["mate_is_unmapped"] = read.mate_is_unmapped
    out["meta"] = meta
    return out


def _fold_outcome(out, state):
    """Fold one outcome snapshot into the scan state (first-wins dedup
    by (qname, is_supplementary), in encounter order).

    Returns 1 when the read is unmapped-informative, else 0.
    """
    (read_hits, reads_seen, read_sv_meta, kmer_coverage,
     read_coverage) = state
    dedup_key = (out["qname"], out["is_supp"])
    if dedup_key in reads_seen:
        return 0
    reads_seen.add(dedup_key)
    if out["unmapped"]:
        return 1
    read_hits.append((out["chrom"], out["start"], out["end"],
                      out["qname"], out["unique"], out["is_supp"]))
    kmer_coverage[out["chrom"]] += out["cov"]
    per_pos = read_coverage[out["chrom"]]
    for pos in out["cov"]:
        per_pos[pos] += 1
    read_sv_meta[dedup_key] = out["meta"]
    return 0


def _process_informative_read(read, unique_in_read, kmer_hit_indices,
                              kmer_size, reads_seen, read_hits,
                              read_sv_meta, kmer_coverage, read_coverage):
    """Record an informative read (reference core/bam_scanner.py:284–337).

    Returns 1 when the read is unmapped-informative, else 0.
    """
    if (read.query_name, read.is_supplementary) in reads_seen:
        return 0
    return _fold_outcome(
        _read_outcome(read, unique_in_read, kmer_hit_indices, kmer_size),
        (read_hits, reads_seen, read_sv_meta, kmer_coverage,
         read_coverage))


def _stripe_enumerated(gen, stripe):
    """(global_index, item) pairs of *gen*, keeping only this stripe."""
    if stripe is None:
        yield from enumerate(gen)
        return
    h, n = stripe
    for i, item in enumerate(gen):
        if i % n == h:
            yield i, item


def _scan_child_reads(child_source, proband_index, kmer_size,
                      min_dk_per_read, state, stripe=None, collect=None):
    """Anchoring scan: batched device probe of every scannable child read.

    *state* is the mutable tuple (read_hits, reads_seen, read_sv_meta,
    kmer_coverage, read_coverage); returns
    (unmapped_informative, total_reads_scanned).

    Two implementations with identical semantics: a packed two-pass
    path (device hit mask over native-decoded batches, Python record
    objects built lazily for the informative minority only — reads are
    ~99.9% uninformative at WGS scale) and the per-record fallback for
    streaming/non-native readers.

    ``stripe=(h, n)`` scans only batch stripe *h* of *n* (multi-host);
    *collect* then gathers ordinal-keyed outcome snapshots instead of
    folding into *state* (see :func:`_process_hit_rows`).
    """
    scanner = eng.make_scanner(proband_index)
    scanner_many = eng.make_scanner_many(proband_index)
    reader = getattr(child_source, "_reader", None)
    if reader is not None and getattr(reader, "_scan", None) is not None:
        it = reader.iter_packed_indexed(_ANCHOR_EXCLUDE_FLAGS,
                                        _ANCHOR_BATCH_READS)
        if it is not None:
            return _scan_child_reads_packed(
                reader, it, scanner_many, kmer_size, min_dk_per_read,
                state, stripe, collect)
    if reader is None and getattr(child_source, "streaming", False):
        from kmer_denovo_filter_tpu_torch.htsio import native
        if native.available():
            return _scan_child_reads_stream(
                child_source, scanner_many, kmer_size,
                min_dk_per_read, state, stripe, collect)
    return _scan_child_reads_records(
        child_source, scanner, kmer_size, min_dk_per_read, state,
        stripe, collect)


def _drain_scan_group(group, scanner_many, kmer_size,
                      min_dk_per_read, state, collect):
    """Scan the buffered (codes, lengths, get_read, bi) group in one
    device pass and fold each batch's hits in order."""
    if not group:
        return 0
    founds = scanner_many([(c, l) for c, l, _g, _b in group])
    unmapped = 0
    for (c, l, get_read, bi), found in zip(group, founds):
        unmapped += _process_hit_rows(
            found, get_read, kmer_size, min_dk_per_read, state,
            collect, bi)
    group.clear()
    return unmapped


def _stream_indexed_batches(path, exclude_flags):
    """(codes, lengths, rec_idx, data, scan, refs) batches over a
    streaming BAM via the native chunk scanner — no per-record Python
    for the stream walk; record objects decode lazily from *data*."""
    from kmer_denovo_filter_tpu_torch.htsio import native
    from kmer_denovo_filter_tpu_torch.htsio.bam import (
        _emit_code_batches,
        stream_scan_chunks,
    )

    for data, scan, refs in stream_scan_chunks(path):
        res = native.bam_codes(data, scan, exclude_flags)
        if res is None:
            raise RuntimeError("native scanner unavailable")
        codes_flat, offsets = res
        keep = (offsets >= 0) & (scan["l_seqs"] > 0)
        lens = scan["l_seqs"][keep].astype(np.int32)
        starts = offsets[keep]
        idx = np.nonzero(keep)[0]
        for out, blens, rec_idx in _emit_code_batches(
                codes_flat, lens, starts, idx, _ANCHOR_BATCH_READS):
            yield out, blens, rec_idx, data, scan, refs


def _scan_groups(batches, scanner_many, kmer_size, min_dk_per_read, state,
                 collect):
    """Group (bi, (codes, lengths, get_read)) batches by NB_JOIN_MEMBER
    (a row count change drains the group early), scan each group in one
    device pass, and fold (or collect) the hits.  Returns
    (unmapped_informative, total_scanned)."""
    unmapped_informative = 0
    total_scanned = 0
    group = []
    for bi, (codes, lengths, get_read) in batches:
        total_scanned += codes.shape[0]
        if codes.shape[1] < kmer_size:
            if not (lengths >= kmer_size).any():
                continue  # nothing scannable in this batch
            codes = np.pad(codes,
                           ((0, 0), (0, kmer_size - codes.shape[1])),
                           constant_values=4)
        if group and codes.shape[0] != group[0][0].shape[0]:
            unmapped_informative += _drain_scan_group(
                group, scanner_many, kmer_size, min_dk_per_read, state,
                collect)
        group.append((codes, lengths, get_read, bi))
        if len(group) >= NB_JOIN_MEMBER:
            unmapped_informative += _drain_scan_group(
                group, scanner_many, kmer_size, min_dk_per_read, state,
                collect)
    unmapped_informative += _drain_scan_group(
        group, scanner_many, kmer_size, min_dk_per_read, state, collect)
    return unmapped_informative, total_scanned


def _scan_child_reads_stream(child_source, scanner_many, kmer_size,
                             min_dk_per_read, state, stripe=None,
                             collect=None):
    """Streaming two-pass scan (WGS BAMs): native chunk decode →
    grouped device mask → lazy record decode for informative rows
    only."""
    from kmer_denovo_filter_tpu_torch.htsio.bam import AlignedRead

    def batches():
        for bi, (codes, lengths, rec_idx, data, scan,
                 refs) in prefetch_batches(_stripe_enumerated(
                     _stream_indexed_batches(
                         child_source.path, _ANCHOR_EXCLUDE_FLAGS),
                     stripe)):

            def get_read(i, rec_idx=rec_idx, data=data, scan=scan,
                         refs=refs):
                ri = int(rec_idx[i])
                o = int(scan["rec_offsets"][ri])
                sz = int(scan["rec_sizes"][ri])
                return AlignedRead(data[o:o + sz], refs)

            yield bi, (codes, lengths, get_read)

    return _scan_groups(batches(), scanner_many, kmer_size,
                        min_dk_per_read, state, collect)


def _process_hit_rows(found, get_read, kmer_size, min_dk_per_read,
                      state, collect=None, batch_ord=0):
    """Shared informative-read handling for all scan paths.

    Folds each qualifying read into *state* directly, or — when
    *collect* is a list (multi-host stripes) — appends
    ``((batch_ord, row), outcome)`` so the global first-wins dedup can
    run after merging every process's outcomes in encounter order.
    """
    (read_hits, reads_seen, read_sv_meta,
     kmer_coverage, read_coverage) = state
    unmapped = 0
    hit_rows = np.nonzero(found.any(axis=1))[0]
    for i in hit_rows:
        read = get_read(int(i))
        seq = read.query_sequence.upper()
        positions = np.nonzero(found[i])[0]
        unique_in_read = set()
        kmer_hit_indices = set()
        for p in positions:
            unique_in_read.add(canonicalize(seq[p:p + kmer_size]))
            kmer_hit_indices.add(int(p))
        if len(unique_in_read) < min_dk_per_read:
            continue
        if collect is not None:
            collect.append(((batch_ord, int(i)), _read_outcome(
                read, unique_in_read, kmer_hit_indices, kmer_size)))
            continue
        unmapped += _process_informative_read(
            read, unique_in_read, kmer_hit_indices, kmer_size,
            reads_seen, read_hits, read_sv_meta, kmer_coverage,
            read_coverage)
    return unmapped


def _scan_child_reads_packed(reader, batches, scanner_many, kmer_size,
                             min_dk_per_read, state, stripe=None,
                             collect=None):
    """Two-pass scan: native packed decode → grouped device mask →
    sparse lazy record decode for informative rows only."""

    def with_reader():
        for bi, (codes, lengths, rec_idx) in prefetch_batches(
                _stripe_enumerated(batches, stripe)):

            def get_read(i, rec_idx=rec_idx):
                return reader.record_at(int(rec_idx[i]))

            yield bi, (codes, lengths, get_read)

    return _scan_groups(with_reader(), scanner_many, kmer_size,
                        min_dk_per_read, state, collect)


def _scan_child_reads_records(child_source, scanner, kmer_size,
                              min_dk_per_read, state, stripe=None,
                              collect=None):
    """Per-record fallback (streaming readers, no native scanner)."""
    unmapped_informative = 0
    total_scanned = 0
    batch = []
    batch_ord = 0

    def _flush(batch):
        nonlocal unmapped_informative, total_scanned, batch_ord
        bi = batch_ord
        batch_ord += 1
        if not batch:
            return
        if stripe is not None:
            if bi % stripe[1] != stripe[0]:
                return  # another process's stripe
            total_scanned += len(batch)
        codes_list = [r.seq_codes() for r in batch]
        lengths = np.array([len(c) for c in codes_list], dtype=np.int32)
        lmax = int(lengths.max())
        codes = np.full((len(batch), max(lmax, kmer_size)), 4,
                        dtype=np.uint8)
        for i, c in enumerate(codes_list):
            codes[i, :len(c)] = c
        found = scanner(codes, lengths)
        unmapped_informative += _process_hit_rows(
            found, lambda i: batch[i], kmer_size, min_dk_per_read,
            state, collect, bi)

    for read in child_source.records_all():
        if read.flag & _ANCHOR_EXCLUDE_FLAGS:
            continue
        if read._l_seq == 0:
            continue
        if stripe is None:
            total_scanned += 1
        if read._l_seq >= kmer_size:
            batch.append(read)
        if len(batch) >= _ANCHOR_BATCH_READS:
            _flush(batch)
            batch = []
    _flush(batch)
    return unmapped_informative, total_scanned


def _anchor_and_cluster(child_source, proband_index, kmer_size,
                        merge_distance=500, min_distinct_kmers_per_read=1,
                        n_proband_unique=None, stripe=None):
    """Module 3: anchoring scan + single-pass region clustering.

    Mirrors reference discovery/pipeline.py:615–1153 with the device
    probe replacing both scanning backends.  With ``stripe=(h, n)``
    each process scans its batch stripe and the sparse outcome
    snapshots allgather + fold in global encounter order, so the
    clustered result is identical to a single-process scan on every
    process.
    """
    anchor_start = time.monotonic()
    logger.info(
        "  Device anchoring scan: %d proband-unique k-mers, "
        "min %d distinct k-mers/read",
        n_proband_unique or proband_index.n, min_distinct_kmers_per_read)

    read_hits = []
    reads_seen = set()
    read_sv_meta = {}
    kmer_coverage = collections.defaultdict(collections.Counter)
    read_coverage = collections.defaultdict(collections.Counter)
    state = (read_hits, reads_seen, read_sv_meta, kmer_coverage,
             read_coverage)
    collect = [] if stripe is not None else None
    unmapped_informative, total_reads_scanned = _scan_child_reads(
        child_source, proband_index, kmer_size,
        min_distinct_kmers_per_read, state, stripe, collect)
    if stripe is not None:
        merged = sorted(
            (item for part in multihost.allgather_object(collect)
             for item in part), key=lambda kv: kv[0])
        unmapped_informative = sum(
            _fold_outcome(out, state) for _ord, out in merged)
        total_reads_scanned = int(multihost.sum_aligned(
            np.int64(total_reads_scanned)))

    log_memory("after anchoring complete")
    total_informative = len(read_hits) + unmapped_informative
    logger.info(
        "Anchoring complete: %d informative reads (%d mapped, %d unmapped) "
        "from %d scanned (%s)",
        total_informative, len(read_hits), unmapped_informative,
        total_reads_scanned, format_elapsed(time.monotonic() - anchor_start))

    if not read_hits:
        return ([], {}, total_informative, {}, unmapped_informative,
                read_sv_meta, kmer_coverage, read_coverage)

    read_hits.sort(key=lambda x: (x[0], x[1]))

    regions = []
    region_reads = {}
    region_kmers = {}
    cur_chrom = read_hits[0][0]
    cur_start = read_hits[0][1]
    cur_end = read_hits[0][2]
    cur_names = {read_hits[0][3]}
    cur_kmers = set(read_hits[0][4])
    for chrom, start, end, name, unique_in_read, _is_supp in read_hits[1:]:
        if chrom == cur_chrom and start <= cur_end + merge_distance:
            cur_end = max(cur_end, end)
            cur_names.add(name)
            cur_kmers.update(unique_in_read)
        else:
            key = (cur_chrom, cur_start, cur_end)
            regions.append(key)
            region_reads[key] = cur_names
            region_kmers[key] = cur_kmers
            cur_chrom, cur_start, cur_end = chrom, start, end
            cur_names = {name}
            cur_kmers = set(unique_in_read)
    key = (cur_chrom, cur_start, cur_end)
    regions.append(key)
    region_reads[key] = cur_names
    region_kmers[key] = cur_kmers

    logger.info("Clustered %d mapped informative reads into %d regions",
                len(read_hits), len(regions))
    return (regions, region_reads, total_informative, region_kmers,
            unmapped_informative, read_sv_meta, kmer_coverage,
            read_coverage)


# ── Output writers (byte-identical to the reference formats) ───────


def _write_bed(regions, region_reads, region_kmers, bed_path,
               region_annotations=None, filters=None):
    """Region BED with counts + SV columns (ref discovery/pipeline.py:1156)."""
    with open(bed_path, "w") as fh:
        if filters:
            parts = " ".join(f"{k}={v}" for k, v in sorted(filters.items()))
            fh.write(f"#filters: {parts}\n")
        fh.write(
            "#chrom\tstart\tend\treads\tunique_kmers"
            "\tsplit_reads\tdiscordant_pairs"
            "\tmax_clip_len\tunmapped_mates\tclass\n")
        for chrom, start, end in regions:
            key = (chrom, start, end)
            n_reads = len(region_reads.get(key, set()))
            n_kmers = len(region_kmers.get(key, set()))
            ann = (region_annotations or {}).get(key, {})
            fh.write(
                f"{chrom}\t{start}\t{end}\t{n_reads}\t{n_kmers}"
                f"\t{ann.get('split_reads', 0)}"
                f"\t{ann.get('discordant_pairs', 0)}"
                f"\t{ann.get('max_clip_len', 0)}"
                f"\t{ann.get('unmapped_mates', 0)}"
                f"\t{ann.get('class', 'SMALL')}\n")
    logger.info("BED file written: %s (%d regions)", bed_path, len(regions))


def _value_runs(values_by_pos):
    """Collapse a {position: value} map into (start, end, value) runs.

    Consecutive positions carrying the same value merge into one
    half-open interval; any gap (missing or filtered position) or
    value change starts a new run.  Shared by the bedGraph and
    read-coverage writers (their reference counterparts each inline
    this merge, ref :1197–1348).
    """
    run_start = run_end = run_val = None
    for pos in sorted(values_by_pos):
        val = values_by_pos[pos]
        if run_start is not None and pos == run_end and val == run_val:
            run_end = pos + 1
            continue
        if run_start is not None:
            yield run_start, run_end, run_val
        run_start, run_end, run_val = pos, pos + 1, val
    if run_start is not None:
        yield run_start, run_end, run_val


def _write_bedgraph(kmer_coverage, bedgraph_path, read_coverage=None,
                    min_reads=3):
    """Run-length-merged k-mer coverage bedGraph (ref :1197–1278)."""
    total_intervals = 0
    total_filtered = 0
    with open(bedgraph_path, "w") as fh:
        fh.write(
            f"#track type=bedGraph "
            f"description=\"De novo k-mer coverage (unique k-mer base "
            f"overlaps per position, min_reads>={min_reads})\"\n")
        for chrom in sorted(kmer_coverage):
            positions = kmer_coverage[chrom]
            rc = read_coverage.get(chrom, {}) if read_coverage else None
            if rc is None:
                kept = positions
            else:
                kept = {pos: val for pos, val in positions.items()
                        if rc.get(pos, 0) >= min_reads}
                total_filtered += len(positions) - len(kept)
            for start, end, val in _value_runs(kept):
                fh.write(f"{chrom}\t{start}\t{end}\t{val}\n")
                total_intervals += 1
    if total_filtered:
        logger.info(
            "bedGraph file written: %s (%d intervals, %d positions "
            "filtered by min_reads=%d)",
            bedgraph_path, total_intervals, total_filtered, min_reads)
    else:
        logger.info("bedGraph file written: %s (%d intervals)",
                    bedgraph_path, total_intervals)


def _write_read_coverage_bed(kmer_coverage, read_coverage, bed_path,
                             min_reads=3):
    """Per-position read support BED (ref :1281–1348)."""
    total_intervals = 0
    with open(bed_path, "w") as fh:
        fh.write(
            f"#track description=\"De novo k-mer read support "
            f"(min_reads>={min_reads})\"\n"
            f"#chrom\tstart\tend\tread_count\tavg_kmers_per_read\n")
        for chrom in sorted(read_coverage):
            rc = read_coverage[chrom]
            kc = kmer_coverage.get(chrom, {})
            kept = {pos: (n_reads, round(kc.get(pos, 0) / n_reads, 1))
                    for pos, n_reads in rc.items()
                    if n_reads >= min_reads}
            for start, end, (n_reads, avg) in _value_runs(kept):
                fh.write(f"{chrom}\t{start}\t{end}"
                         f"\t{n_reads}\t{avg}\n")
                total_intervals += 1
    logger.info("Read coverage BED written: %s (%d intervals)",
                bed_path, total_intervals)


class _RegionLocator:
    """Point-in-region queries over the clustered region set.

    Per-chromosome sorted starts + binary search; regions never
    overlap after clustering, so at most one can contain a position.
    """

    def __init__(self, regions):
        self._by_chrom = {}
        for region in sorted(regions):
            self._by_chrom.setdefault(region[0], []).append(region)
        self._starts = {chrom: [r[1] for r in rs]
                        for chrom, rs in self._by_chrom.items()}

    def region_at(self, chrom, pos):
        """The (chrom, start, end) region containing *pos*, or None."""
        starts = self._starts.get(chrom)
        if not starts:
            return None
        i = bisect.bisect_right(starts, pos) - 1
        if i < 0:
            return None
        region = self._by_chrom[chrom][i]
        return region if pos < region[2] else None


def _sa_breakpoints(sa_str):
    """(chrom, 0-based pos) per supplementary alignment in an SA tag.

    SA is ``rname,pos,strand,CIGAR,mapQ,NM;`` repeated; malformed
    entries are skipped.
    """
    if not sa_str:
        return
    for entry in sa_str.rstrip(";").split(";"):
        fields = entry.split(",")
        if len(fields) < 3:
            continue
        try:
            yield fields[0], int(fields[1]) - 1
        except ValueError:
            continue


def _read_sv_profiles(read_sv_meta, member_names):
    """Collapse per-alignment SV metadata into one profile per read.

    A read name may carry several alignment records (primary +
    supplementary, keyed by ``(qname, is_supplementary)``).  The
    profile keeps what region annotation needs: whether ANY record has
    an SA tag (split evidence is per-molecule), the per-record
    discordant / unmapped-mate tallies (those stay per-alignment), the
    largest softclip, and every SA string for breakpoint resolution.
    """
    profiles = {}
    for dedup_key, meta in read_sv_meta.items():
        qname = dedup_key[0]
        if qname not in member_names:
            continue
        prof = profiles.get(qname)
        if prof is None:
            prof = profiles[qname] = {
                "split": False, "discordant": 0, "unmapped": 0,
                "clip": 0, "sa_strs": []}
        prof["split"] = prof["split"] or meta["has_sa"]
        if meta["is_paired"]:
            if meta["mate_is_unmapped"]:
                prof["unmapped"] += 1
            elif not meta["is_proper_pair"]:
                prof["discordant"] += 1
        if meta["max_clip"] > prof["clip"]:
            prof["clip"] = meta["max_clip"]
        if meta.get("sa_str"):
            prof["sa_strs"].append(meta["sa_str"])
    return profiles


def _annotate_and_link_from_metadata(regions, region_reads, read_sv_meta):
    """SV annotation + SA-tag breakpoint linking (ref :1351–1489).

    Works in two stages over per-read profiles (one per read name,
    built by :func:`_read_sv_profiles`): stage 1 folds each profile
    into every region the read supports; stage 2 derives breakpoint
    links from resolved SA-tag targets plus shared-read co-membership.
    Output parity with the reference is pinned by the golden discovery
    tests (BED name fields, BEDPE rows, metrics region detail).
    """
    annotations = {
        r: {"split_reads": 0, "discordant_pairs": 0,
            "max_clip_len": 0, "unmapped_mates": 0}
        for r in regions
    }
    regions_of = {}
    for region_key in regions:
        for qname in region_reads.get(region_key, set()):
            regions_of.setdefault(qname, set()).add(region_key)
    if not regions_of:
        return annotations, []

    profiles = _read_sv_profiles(read_sv_meta, regions_of)

    # Stage 1: fold each read's profile into all its regions.  The
    # split-read tally counts molecules (profile granularity), the
    # pair-status tallies count alignment records (summed in the
    # profile), and the clip length is a running maximum.
    for qname, prof in profiles.items():
        for region_key in regions_of[qname]:
            ann = annotations[region_key]
            if prof["split"]:
                ann["split_reads"] += 1
            ann["unmapped_mates"] += prof["unmapped"]
            ann["discordant_pairs"] += prof["discordant"]
            if prof["clip"] > ann["max_clip_len"]:
                ann["max_clip_len"] = prof["clip"]

    # Stage 2: bridge region pairs.  An SA breakpoint landing inside a
    # different region links the read's home regions to it; reads that
    # are members of several regions link those regions directly.
    locator = _RegionLocator(regions)
    bridges = {}

    def bridge(a, b, qname):
        pair = (a, b) if a <= b else (b, a)
        bridges.setdefault(pair, set()).add(qname)

    for qname, prof in profiles.items():
        homes = regions_of[qname]
        targets = set()
        for sa_str in prof["sa_strs"]:
            for sa_chrom, sa_pos in _sa_breakpoints(sa_str):
                hit = locator.region_at(sa_chrom, sa_pos)
                if hit is not None:
                    targets.add(hit)
        for target in targets:
            for home in homes:
                if home != target:
                    bridge(home, target, qname)
    for qname, homes in regions_of.items():
        if len(homes) > 1:
            ordered = sorted(homes)
            for i, low in enumerate(ordered):
                for high in ordered[i + 1:]:
                    bridge(low, high, qname)

    return annotations, [
        {"region_a": a, "region_b": b,
         "supporting_reads": bridges[(a, b)],
         "sv_type_hint": _infer_sv_type(a, b)}
        for a, b in sorted(bridges)]


def _write_bedpe(links, bedpe_path):
    """Linked SV breakpoint BEDPE (ref :1492–1514)."""
    with open(bedpe_path, "w") as fh:
        fh.write("#chrom1\tstart1\tend1\tchrom2\tstart2\tend2"
                 "\tsv_id\tsupporting_reads\tsv_type\n")
        for idx, link in enumerate(links, 1):
            ra = link["region_a"]
            rb = link["region_b"]
            fh.write(f"{ra[0]}\t{ra[1]}\t{ra[2]}"
                     f"\t{rb[0]}\t{rb[1]}\t{rb[2]}"
                     f"\tSV_{idx}\t{len(link['supporting_reads'])}"
                     f"\t{link['sv_type_hint']}\n")
    logger.info("BEDPE file written: %s (%d links)", bedpe_path, len(links))


def _classify_regions(regions, region_annotations, sv_links):
    """SV / AMBIGUOUS / SMALL classification (ref :1517–1546)."""
    linked = set()
    for link in sv_links:
        linked.add(link["region_a"])
        linked.add(link["region_b"])
    for region_key in regions:
        ann = region_annotations.get(region_key, {})
        split_reads = ann.get("split_reads", 0)
        discordant = ann.get("discordant_pairs", 0)
        unmapped_mates = ann.get("unmapped_mates", 0)
        if (split_reads >= 2 or discordant >= 2 or unmapped_mates >= 2
                or region_key in linked):
            ann["class"] = "SV"
        elif split_reads == 0 and discordant == 0 and unmapped_mates == 0:
            ann["class"] = "SMALL"
        else:
            ann["class"] = "AMBIGUOUS"
        region_annotations[region_key] = ann


def _parse_candidate_summary(summary_path, dka_dkt_min=0.25, dka_min=10):
    """High-quality candidates from a VCF-mode summary (ref :1549–1606).

    Delegates the Per-Variant table parsing to the report module's
    loader (one parser for the format) and applies the discovery
    HQ thresholds on top.
    """
    from kmer_denovo_filter_tpu_torch.report import _load_summary_variants

    candidates = []
    for v in _load_summary_variants(summary_path):
        if not (v["dka_dkt"] > dka_dkt_min and v["dka"] > dka_min):
            continue
        chrom, pos_str = v["variant"].split(" ")[0].rsplit(":", 1)
        ref, _, alt = v["label"].partition(">")
        candidates.append({
            "chrom": chrom, "pos": int(pos_str),
            "ref": ref, "alt": alt,
            "dka": v["dka"], "dka_dkt": v["dka_dkt"],
            "call": v["call"],
        })
    return candidates


def _compare_candidates_to_regions(candidates, regions):
    """Mark candidates captured by discovery regions (ref :1609–1634)."""
    results = []
    for cand in candidates:
        captured = False
        match_region = None
        for chrom, start, end in regions:
            if cand["chrom"] == chrom and start < cand["pos"] <= end:
                captured = True
                match_region = f"{chrom}:{start + 1}-{end}"
                break
        results.append({**cand, "captured": captured,
                        "region": match_region})
    return results


#: Curated de novo mutation regions from Sulovari et al. 2023
#: (PMID: 36894594, PMC10006329); (chrom, pos, size_bp_or_None, type).
SULOVARI_DNM_REGIONS = [
    ("chr17", 53340465, 107, "deletion"),
    ("chr14", 23280711, None, "microsatellite_expansion"),
    ("chr3", 85552367, 64, "sv_like"),
    ("chr5", 97089276, 43, "sv_like"),
    ("chr8", 125785998, 43, "sv_like"),
    ("chr18", 62805217, 34, "sv_like"),
    ("chr7", 142786222, 10607, "deletion"),
]


def _evaluate_dnm_regions(discovery_regions, region_detail,
                          dnm_regions=None):
    """Curated DNM locus detection evaluation (ref :1653–1783)."""
    if dnm_regions is None:
        dnm_regions = SULOVARI_DNM_REGIONS
    detail_by_key = {
        (rd["chrom"], rd["start"], rd["end"]): rd for rd in region_detail
    }
    class_rank = {"SV": 3, "AMBIGUOUS": 2, "SMALL": 1}
    results = []
    for chrom, pos, size, event_type in dnm_regions:
        dnm_start, dnm_end = pos, pos + (size or 1)
        hits = [(rk, detail_by_key.get(rk, {})) for rk in discovery_regions
                if rk[0] == chrom and rk[1] < dnm_end and dnm_start < rk[2]]
        detected = bool(hits)

        # Sum region-detail tallies across every overlapping discovery
        # region; the k-mer signal density is normalised by the merged
        # span of the curated locus plus all its hits.
        def total(field):
            return sum(rd.get(field, 0) for _rk, rd in hits)

        span_start = min([dnm_start] + [rk[1] for rk, _rd in hits])
        span_end = max([dnm_end] + [rk[2] for rk, _rd in hits])
        total_kmers = total("unique_kmers")
        kmer_signal = (total_kmers / max(span_end - span_start, 1)
                       if detected else 0.0)
        sv_class = "NONE"
        for _rk, rd in hits:
            cls = rd.get("class", "SMALL")
            if class_rank.get(cls, 0) > class_rank.get(sv_class, 0):
                sv_class = cls

        results.append({
            "locus": f"{chrom}:{pos}",
            "event_type": event_type,
            "event_size": size,
            "detected": detected,
            "discovery_regions": [f"{rk[0]}:{rk[1] + 1}-{rk[2]}"
                                  for rk, _rd in hits],
            "total_reads": total("reads"),
            "total_unique_kmers": total_kmers,
            "max_clip_len": max([0] + [rd.get("max_clip_len", 0)
                                       for _rk, rd in hits]),
            "unmapped_mates": total("unmapped_mates"),
            "discordant_pairs": total("discordant_pairs"),
            "split_reads": total("split_reads"),
            "sv_class": sv_class,
            "kmer_signal": round(kmer_signal, 4),
            "assessment": "DETECTED" if detected else "NOT_DETECTED",
        })
    return results


def _write_discovery_summary(summary_path, regions, region_reads,
                             region_kmers, metrics,
                             candidate_comparison=None,
                             region_annotations=None,
                             dnm_evaluation=None):
    """Byte-identical discovery summary (ref :1786–1976)."""
    n_regions = metrics["candidate_regions"]
    n_reads_total = metrics["informative_reads"]
    n_unmapped = metrics.get("unmapped_informative_reads", 0)
    n_unique_kmers = metrics["proband_unique_kmers"]
    n_candidates = metrics["child_candidate_kmers"]
    n_non_ref = metrics["non_ref_kmers"]

    lines = []
    lines.append("=" * 60)
    lines.append("  kmer-denovo  —  Discovery Mode Summary")
    lines.append("=" * 60)
    lines.append("")
    lines.append("K-mer Filtering")
    lines.append("-" * 40)
    lines.append(f"  Child candidate k-mers:      {n_candidates:>8}")
    lines.append(f"  Non-reference k-mers:        {n_non_ref:>8}")
    lines.append(f"  Proband-unique k-mers:       {n_unique_kmers:>8}")
    lines.append("")
    lines.append("Region Counts")
    lines.append("-" * 40)
    lines.append(f"  Candidate regions:           {n_regions:>8}")
    lines.append(f"  Total informative reads:     {n_reads_total:>8}")
    if n_unmapped > 0:
        lines.append(f"    (unmapped informative):     {n_unmapped:>8}")
    lines.append("")

    if regions:
        reads_per_region = [len(region_reads.get(r, set()))
                            for r in regions]
        kmers_per_region = [len(region_kmers.get(r, set()))
                            for r in regions]
        sizes = [end - start for _, start, end in regions]
        lines.append("Region Statistics")
        lines.append("-" * 40)
        lines.append(
            f"  Reads/region   mean: {sum(reads_per_region) / len(reads_per_region):>6.1f}"
            f"   median: {statistics.median(reads_per_region):>4}"
            f"   max: {max(reads_per_region):>4}")
        lines.append(
            f"  K-mers/region  mean: {sum(kmers_per_region) / len(kmers_per_region):>6.1f}"
            f"   median: {statistics.median(kmers_per_region):>4}"
            f"   max: {max(kmers_per_region):>4}")
        lines.append(
            f"  Region size    mean: {sum(sizes) / len(sizes):>6.0f} bp"
            f"   median: {statistics.median(sizes):>4} bp"
            f"   max: {max(sizes):>4} bp")
        lines.append("")

    if regions:
        lines.append("Per-Region Results")
        lines.append("-" * 120)
        lines.append(
            f"  {'Region':<35s} {'Size':>8s} {'Reads':>6s}"
            f" {'Unique K-mers':>14s}"
            f" {'Split':>6s} {'Disc':>5s} {'MaxClip':>8s}"
            f" {'UnmapMate':>10s} {'Class':>10s}")
        lines.append(
            f"  {'------':<35s} {'----':>8s} {'-----':>6s}"
            f" {'-------------':>14s}"
            f" {'-----':>6s} {'----':>5s} {'-------':>8s}"
            f" {'---------':>10s} {'-----':>10s}")
        for chrom, start, end in regions:
            key = (chrom, start, end)
            n_reads = len(region_reads.get(key, set()))
            n_kmers = len(region_kmers.get(key, set()))
            ann = (region_annotations or {}).get(key, {})
            label = f"{chrom}:{start + 1}-{end}"
            lines.append(
                f"  {label:<35s} {end - start:>7d}bp {n_reads:>6d}"
                f" {n_kmers:>14d}"
                f" {ann.get('split_reads', 0):>6d}"
                f" {ann.get('discordant_pairs', 0):>5d}"
                f" {ann.get('max_clip_len', 0):>8d}"
                f" {ann.get('unmapped_mates', 0):>10d}"
                f" {ann.get('class', 'SMALL'):>10s}")

    if candidate_comparison:
        n_total = len(candidate_comparison)
        n_captured = sum(1 for c in candidate_comparison if c["captured"])
        pct = (n_captured / n_total * 100) if n_total else 0.0
        lines.append("Candidate Comparison (DKA_DKT > 0.25, DKA > 10)")
        lines.append("-" * 80)
        lines.append(f"  High-quality candidates:     {n_total:>8}")
        lines.append(f"  Captured by discovery:       {n_captured:>8}"
                     f" / {n_total} ({pct:.1f}%)")
        lines.append("")
        lines.append(f"  {'Candidate':<30s}  {'DKA':>4s}  {'DKA_DKT':>8s}"
                     f"  {'Region':>35s}")
        lines.append(f"  {'---------':<30s}  {'---':>4s}  {'-------':>8s}"
                     f"  {'------':>35s}")
        for c in candidate_comparison:
            var_label = f"{c['chrom']}:{c['pos']} {c['ref']}>{c['alt']}"
            region_label = c["region"] if c["captured"] else "NOT CAPTURED"
            lines.append(
                f"  {var_label:<30s}  {c['dka']:>4d}  {c['dka_dkt']:>8.4f}"
                f"  {region_label:>35s}")
        lines.append("")

    if dnm_evaluation:
        n_total = len(dnm_evaluation)
        n_detected = sum(1 for e in dnm_evaluation if e["detected"])
        pct = (n_detected / n_total * 100) if n_total else 0.0
        lines.append("Curated DNM Region Evaluation (Sulovari et al. 2023)")
        lines.append("-" * 80)
        lines.append(f"  Curated DNM loci:            {n_total:>8}")
        lines.append(f"  Detected by discovery:       {n_detected:>8}"
                     f" / {n_total} ({pct:.1f}%)")
        lines.append("")
        lines.append(
            f"  {'Locus':<20s} {'Event':>25s} {'Size':>8s}"
            f" {'Reads':>6s} {'Kmers':>6s} {'Signal':>7s}"
            f" {'MaxClip':>8s} {'Class':>10s} {'Status':>14s}")
        lines.append(
            f"  {'-----':<20s} {'-----':>25s} {'----':>8s}"
            f" {'-----':>6s} {'-----':>6s} {'------':>7s}"
            f" {'-------':>8s} {'-----':>10s} {'------':>14s}")
        for e in dnm_evaluation:
            size_str = f"{e['event_size']}bp" if e["event_size"] else "–"
            lines.append(
                f"  {e['locus']:<20s}"
                f" {e['event_type']:>25s}"
                f" {size_str:>8s}"
                f" {e['total_reads']:>6d}"
                f" {e['total_unique_kmers']:>6d}"
                f" {e['kmer_signal']:>7.4f}"
                f" {e['max_clip_len']:>8d}"
                f" {e['sv_class']:>10s}"
                f" {e['assessment']:>14s}")
        lines.append("")

    lines.append("=" * 60)
    lines.append("")
    text = "\n".join(lines)
    with open(summary_path, "w") as fh:
        fh.write(text)
    return text


def _write_informative_reads_discovery(child_source, proband_index,
                                       kmer_size, output_bam,
                                       stripe=None):
    """dk:i:1-tagged informative reads BAM (ref :1979–2079).

    The reference iterates ``bam.fetch()`` (mapped + placed-unmapped
    reads, excluding the unplaced-unmapped block); replicated here.
    With ``stripe=(h, n)`` each host scans its batch stripe, the raw
    records of informative rows allgather, and process 0 alone writes
    the (coordinate-sorted) output with global first-wins dedup.
    """
    from kmer_denovo_filter_tpu_torch.htsio.bam import AlignedRead

    log_memory("before informative reads scan")
    scanner = eng.make_scanner(proband_index)
    written = set()
    collect = [] if stripe is not None else None
    writer = None
    if stripe is None or stripe[0] == 0:
        writer = BamWriter(output_bam, child_source.header_text,
                           child_source.refs)

    def _emit(read):
        dedup_key = (read.query_name, read.is_supplementary)
        if dedup_key in written:
            return
        read.set_tag("dk", 1, value_type="i")
        writer.write(read)
        written.add(dedup_key)

    def _handle(ordinal, read):
        if collect is not None:
            collect.append((ordinal, bytes(read._raw)))
        else:
            _emit(read)

    reader = getattr(child_source, "_reader", None)
    packed = None
    if reader is not None and getattr(reader, "_scan", None) is not None:
        # exclude secondary | duplicate (0x500); placed-only and the
        # dk-tagging happen lazily on the informative minority
        packed = reader.iter_packed_indexed(0x500, _ANCHOR_BATCH_READS)
    streaming_native = False
    if packed is None and getattr(child_source, "streaming", False):
        from kmer_denovo_filter_tpu_torch.htsio import native
        streaming_native = native.available()
    if packed is not None:
        tids = reader._scan["tids"]
        for bi, (codes, lengths, rec_idx) in prefetch_batches(
                _stripe_enumerated(packed, stripe)):
            if codes.shape[1] < kmer_size:
                if not (lengths >= kmer_size).any():
                    continue
                codes = np.pad(
                    codes, ((0, 0), (0, kmer_size - codes.shape[1])),
                    constant_values=4)
            found = scanner(codes, lengths)
            for i in np.nonzero(found.any(axis=1))[0]:
                ri = int(rec_idx[i])
                if tids[ri] < 0:
                    continue  # records_placed() writes placed only
                _handle((bi, int(i)), reader.record_at(ri))
    elif streaming_native:
        batches = _stream_indexed_batches(child_source.path, 0x500)
        for bi, (codes, lengths, rec_idx, data, scan,
                 refs) in prefetch_batches(
                _stripe_enumerated(batches, stripe)):
            if codes.shape[1] < kmer_size:
                if not (lengths >= kmer_size).any():
                    continue
                codes = np.pad(
                    codes, ((0, 0), (0, kmer_size - codes.shape[1])),
                    constant_values=4)
            found = scanner(codes, lengths)
            for i in np.nonzero(found.any(axis=1))[0]:
                ri = int(rec_idx[i])
                if scan["tids"][ri] < 0:
                    continue
                o = int(scan["rec_offsets"][ri])
                sz = int(scan["rec_sizes"][ri])
                _handle((bi, int(i)), AlignedRead(data[o:o + sz], refs))
    else:
        batch = []
        batch_ord = 0

        def _flush(batch):
            nonlocal batch_ord
            bi = batch_ord
            batch_ord += 1
            if not batch:
                return
            if stripe is not None and bi % stripe[1] != stripe[0]:
                return
            codes_list = [r.seq_codes() for r in batch]
            lengths = np.array([len(c) for c in codes_list],
                               dtype=np.int32)
            lmax = int(lengths.max())
            codes = np.full((len(batch), max(lmax, kmer_size)), 4,
                            dtype=np.uint8)
            for i, c in enumerate(codes_list):
                codes[i, :len(c)] = c
            found = scanner(codes, lengths)
            for i in np.nonzero(found.any(axis=1))[0]:
                _handle((bi, int(i)), batch[i])

        for read in child_source.records_placed():
            if read.is_secondary or read.is_duplicate:
                continue
            if read._l_seq < kmer_size:
                continue
            batch.append(read)
            if len(batch) >= _ANCHOR_BATCH_READS:
                _flush(batch)
                batch = []
        _flush(batch)

    if collect is not None:
        merged = sorted(
            (item for part in multihost.allgather_object(collect)
             for item in part), key=lambda kv: kv[0])
        if writer is None:
            return  # only process 0 writes
        for _ordinal, raw in merged:
            _emit(AlignedRead(raw, child_source.refs))
    writer.close(sort=True, index=True)
    logger.info("Informative reads BAM written: %s (%d reads)",
                output_bam, len(written))


def _write_empty_discovery_outputs(bed_path, metrics_path, summary_path,
                                   metrics, bedpe_path=None):
    """Valid empty outputs for early-exit cases (ref :2082–2090)."""
    _write_bed([], {}, {}, bed_path)
    if bedpe_path:
        _write_bedpe([], bedpe_path)
    with open(metrics_path, "w") as fh:
        json.dump(metrics, fh, indent=2)
    _write_discovery_summary(summary_path, [], {}, {}, metrics)


# ── Pipeline driver ────────────────────────────────────────────────


def _run_discovery_pipeline_impl(args, device):
    """Run the VCF-free discovery pipeline (reference :2093–2592) with
    the device work on *device*."""
    pipeline_start = time.monotonic()
    logging.basicConfig(
        level=logging.DEBUG if args.debug_kmers else logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s")

    validate_inputs(args)

    out_prefix = args.out_prefix
    bed_path = f"{out_prefix}.bed"
    info_bam_path = f"{out_prefix}.informative.bam"
    metrics_path = f"{out_prefix}.metrics.json"
    summary_path = f"{out_prefix}.summary.txt"
    bedpe_path = getattr(args, "sv_bedpe", None) or f"{out_prefix}.sv.bedpe"
    bedgraph_path = f"{out_prefix}.kmer_coverage.bedgraph"
    read_cov_bed_path = f"{out_prefix}.read_coverage.bed"
    min_bedgraph_reads = getattr(args, "min_bedgraph_reads", 3)
    min_dk_per_read = getattr(args, "min_distinct_kmers_per_read", None)
    if min_dk_per_read is None:
        min_dk_per_read = max(1, args.kmer_size // 4)
    memory_limit_gb = getattr(args, "memory", None)

    # Multi-host deployment (KDF_COORDINATOR env / N processes): every
    # process consumes its own input stripe of each BAM, partial results
    # merge at module boundaries, and process 0 alone writes outputs.
    stripe = multihost.stripe()
    primary = multihost.is_primary()
    if stripe is not None:
        logger.info("  Multi-host run: process %d of %d (input stripe)",
                    stripe[0], stripe[1])

    def _finish_empty(reason, n_candidates=0, n_non_ref=0):
        """Early exit: valid empty outputs + zeroed funnel metrics.

        Shared by the three no-signal exits (no candidates / all in
        reference / none proband-unique — ref :2207, :2239, :2279);
        the metric keys and log text are byte-pinned.
        """
        logger.warning("%s; writing empty outputs", reason)
        if primary:
            _write_empty_discovery_outputs(
                bed_path, metrics_path, summary_path,
                {"mode": "discovery",
                 "child_candidate_kmers": n_candidates,
                 "non_ref_kmers": n_non_ref,
                 "proband_unique_kmers": 0,
                 "informative_reads": 0,
                 "unmapped_informative_reads": 0,
                 "candidate_regions": 0},
                bedpe_path=bedpe_path)
        logger.info("Pipeline finished in %s",
                    format_elapsed(time.monotonic() - pipeline_start))

    logger.info("=" * 60)
    logger.info("  kmer-denovo  —  discovery pipeline starting")
    logger.info("=" * 60)
    logger.info("  Child BAM/CRAM:    %s (%s)", args.child,
                format_file_size(args.child))
    logger.info("  Mother BAM/CRAM:   %s (%s)", args.mother,
                format_file_size(args.mother))
    logger.info("  Father BAM/CRAM:   %s (%s)", args.father,
                format_file_size(args.father))
    logger.info("  Reference FASTA:   %s", args.ref_fasta or "(not set)")
    logger.info("  Reference JF:      %s",
                getattr(args, "ref_jf", None) or "(auto)")
    logger.info("  Output prefix:     %s", out_prefix)
    logger.info("  k-mer size:        %d", args.kmer_size)
    logger.info("  Min child count:   %d", args.min_child_count)
    logger.info("  Min base quality:  %d", args.min_baseq)
    logger.info("  Min distinct kmers/read: %d", min_dk_per_read)
    logger.info("  Threads:           %d", args.threads)
    logger.info("  Memory limit:      %s",
                f"{memory_limit_gb:.1f} GB" if memory_limit_gb is not None
                else "(auto-detect)")
    logger.info("  Tmp dir:           %s",
                getattr(args, "tmp_dir", None) or "(auto)")
    logger.info("  Device:            %s", device)
    # resource flags tune the host side of the engine: --threads sizes
    # the BGZF inflation pool, --memory the stream-counter merge floor
    # (explicit env vars win)
    os.environ.setdefault("KDF_BGZF_THREADS", str(args.threads))
    if memory_limit_gb is not None:
        os.environ.setdefault(
            "KDF_MERGE_ROWS", str(int(memory_limit_gb * 8) << 20))
    total_mem_gb, avail_mem_gb = get_available_memory_gb()
    if total_mem_gb is not None:
        logger.info("  System memory:     %.1f GB total, %s available",
                    total_mem_gb,
                    f"{avail_mem_gb:.1f} GB" if avail_mem_gb is not None
                    else "(unknown)")
    logger.info("=" * 60)
    # CRAM inputs: convert once up front so every downstream consumer
    # (streaming packed batches, BAI fetch, native inflate) sees BAM
    from kmer_denovo_filter_tpu_torch.htsio.bam import resolve_alignment_input
    for _attr in ("child", "mother", "father"):
        _p = getattr(args, _attr)
        _rp = resolve_alignment_input(_p, args.ref_fasta)
        if _rp != _p:
            logger.info("CRAM input converted: %s -> %s", _p, _rp)
            setattr(args, _attr, _rp)
    log_memory("pipeline start")

    out_dir = os.path.dirname(os.path.abspath(out_prefix)) or "."
    tmp_root = resolve_tmp_dir(args.tmp_dir, out_dir)
    logger.info("  Temp directory root: %s", tmp_root)
    if is_tmpfs(tmp_root):
        logger.warning(
            "  ⚠ Temp directory %s appears to be on tmpfs (RAM-backed)! "
            "Consider using --tmp-dir to point to a disk-backed "
            "filesystem.", tmp_root)
    log_disk_usage(tmp_root, "tmpdir filesystem")

    # ── Optional resume from a proband-unique index snapshot ───────
    # (the checkpoint/resume capability SURVEY §5 calls for: re-run
    # Modules 3+ with different clustering/filter knobs without
    # repeating the counting and parent filtering)
    resume_path = getattr(args, "proband_index", None)
    if resume_path:
        logger.info("[Modules 0-2] Skipped: resuming from proband-"
                    "unique index snapshot %s", resume_path)
        snap = np.load(resume_path)
        snap_k = int(snap["k"])
        if snap_k != args.kmer_size:
            raise ValueError(
                f"index snapshot {resume_path} has k={snap_k}, "
                f"expected k={args.kmer_size}")
        proband_keys = snap["keys"]
        n_proband_unique = int(proband_keys.shape[0])
        n_candidates = int(snap["child_candidate_kmers"])
        n_non_ref = int(snap["non_ref_kmers"])
    else:
        # ── Module 0: Reference k-mer index ────────────────────────────
        step_start = time.monotonic()
        logger.info("[Module 0] Ensuring reference k-mer index")
        ref_index = ensure_ref_index(
            args.ref_fasta, args.kmer_size, getattr(args, "ref_jf", None),
            device=device)
        logger.info("[Module 0] Reference index ready (%s)",
                    format_elapsed(time.monotonic() - step_start))
        log_memory("after Module 0")

        # ── Module 1: Child k-merization & reference subtraction ───────
        step_start = time.monotonic()
        logger.info("[Module 1] Child k-mer extraction & reference subtraction")
        candidate_keys, n_candidates = _extract_child_kmers_discovery(
            args.child, args.kmer_size, args.min_child_count, device,
            stripe=stripe)

        if n_candidates == 0:
            _finish_empty("No child candidate k-mers found")
            return

        non_ref_keys, n_non_ref = _subtract_reference_kmers(
            ref_index, candidate_keys, stripe=stripe)
        logger.info("[Module 1] Complete (%s)",
                    format_elapsed(time.monotonic() - step_start))
        log_memory("after Module 1")

        if n_non_ref == 0:
            _finish_empty("All child k-mers are in the reference",
                          n_candidates=n_candidates)
            return

        # ── Module 2: Parent filtering ─────────────────────────────────
        step_start = time.monotonic()
        logger.info("[Module 2] Parent filtering")
        n_proband_unique, proband_keys = _filter_parents_discovery(
            args.mother, args.father, non_ref_keys, args.kmer_size,
            parent_max_count=args.parent_max_count, device=device,
            stripe=stripe)
        logger.info("[Module 2] Complete (%s)",
                    format_elapsed(time.monotonic() - step_start))
        log_memory("after Module 2")

    if n_proband_unique == 0:
        _finish_empty("No proband-unique k-mers after parent filtering",
                      n_candidates=n_candidates, n_non_ref=n_non_ref)
        return

    # ── Module 2b: proband-unique device index ─────────────────────
    step_start = time.monotonic()
    logger.info("[Module 2b] Building device index of %d proband-unique "
                "k-mers", n_proband_unique)
    proband_index = eng.KmerIndex(proband_keys, args.kmer_size,
                                  device=device)
    logger.info("[Module 2b] Complete (%s)",
                format_elapsed(time.monotonic() - step_start))
    if getattr(args, "save_proband_index", False) and primary:
        snap_path = f"{out_prefix}.proband_unique.kdx.npz"
        np.savez(snap_path, keys=proband_keys, k=args.kmer_size,
                 child_candidate_kmers=n_candidates,
                 non_ref_kmers=n_non_ref)
        logger.info("Proband-unique index snapshot written: %s "
                    "(resume with --proband-index)", snap_path)

    # ── Module 3: Anchoring & region clustering ────────────────────
    step_start = time.monotonic()
    logger.info("[Module 3] Anchoring %d proband-unique k-mers to child "
                "reads (device probe)", n_proband_unique)
    log_memory("before Module 3")
    child_source = _ChildSource(args.child, args.ref_fasta)
    (regions, region_reads, total_informative, region_kmers,
     unmapped_informative, read_sv_meta, kmer_coverage,
     read_coverage) = _anchor_and_cluster(
        child_source, proband_index, args.kmer_size,
        merge_distance=args.cluster_distance,
        min_distinct_kmers_per_read=min_dk_per_read,
        n_proband_unique=n_proband_unique, stripe=stripe)
    logger.info("[Module 3] Complete (%s)",
                format_elapsed(time.monotonic() - step_start))
    log_memory("after Module 3")

    # ── Module 4: informative BAM ──────────────────────────────────
    logger.info("[Module 4] Writing informative reads BAM: %s",
                info_bam_path)
    _write_informative_reads_discovery(
        child_source, proband_index, args.kmer_size, info_bam_path,
        stripe=stripe)

    try:
        if not getattr(args, "tmp_dir", None) and os.path.isdir(tmp_root):
            os.rmdir(tmp_root)
    except OSError:
        pass

    # ── Region filtering ───────────────────────────────────────────
    min_reads = args.min_supporting_reads
    min_kmers = args.min_distinct_kmers
    if min_reads > 1 or min_kmers > 1:
        pre_filter = len(regions)
        survivors = [
            rk for rk in regions
            if (len(region_reads.get(rk, ())) >= min_reads
                and len(region_kmers.get(rk, ())) >= min_kmers)]
        for dropped in set(regions).difference(survivors):
            region_reads.pop(dropped, None)
            region_kmers.pop(dropped, None)
        regions = survivors
        logger.info(
            "Region filtering: %d → %d regions "
            "(min-supporting-reads=%d, min-distinct-kmers=%d)",
            pre_filter, len(regions), min_reads, min_kmers)

    # ── Module 4: outputs ──────────────────────────────────────────
    step_start = time.monotonic()
    logger.info("[Module 4] Writing output files")
    logger.info("[Module 4] Annotating regions and linking breakpoints")
    region_annotations, sv_links = _annotate_and_link_from_metadata(
        regions, region_reads, read_sv_meta)
    _classify_regions(regions, region_annotations, sv_links)

    bed_filters = {
        "min_distinct_kmers_per_read": min_dk_per_read,
        "min_supporting_reads": min_reads,
        "min_distinct_kmers": min_kmers,
    }
    if primary:
        _write_bed(regions, region_reads, region_kmers, bed_path,
                   region_annotations=region_annotations,
                   filters=bed_filters)
        _write_bedgraph(kmer_coverage, bedgraph_path,
                        read_coverage=read_coverage,
                        min_reads=min_bedgraph_reads)
        _write_read_coverage_bed(kmer_coverage, read_coverage,
                                 read_cov_bed_path,
                                 min_reads=min_bedgraph_reads)

    logger.info(
        "  Coverage data: kmer_coverage=%d chroms, read_coverage=%d chroms",
        len(kmer_coverage), len(read_coverage))
    total_positions = sum(len(v) for v in kmer_coverage.values())
    logger.info("  Total tracked positions: %d", total_positions)
    del kmer_coverage
    del read_coverage
    log_memory("after freeing coverage data")

    if primary:
        _write_bedpe(sv_links, bedpe_path)

    candidate_comparison = None
    candidate_summary = getattr(args, "candidate_summary", None)
    if candidate_summary and os.path.isfile(candidate_summary):
        logger.info("[Module 4] Comparing to candidate summary: %s",
                    candidate_summary)
        hq_candidates = _parse_candidate_summary(candidate_summary)
        candidate_comparison = _compare_candidates_to_regions(
            hq_candidates, regions)
        n_captured = sum(1 for c in candidate_comparison if c["captured"])
        logger.info("[Module 4] High-quality candidates: %d, captured: %d",
                    len(candidate_comparison), n_captured)

    metrics = {
        "mode": "discovery",
        "child_candidate_kmers": n_candidates,
        "non_ref_kmers": n_non_ref,
        "proband_unique_kmers": n_proband_unique,
        "informative_reads": total_informative,
        "unmapped_informative_reads": unmapped_informative,
        "candidate_regions": len(regions),
        "filters": {
            "min_distinct_kmers_per_read": min_dk_per_read,
            "min_supporting_reads": min_reads,
            "min_distinct_kmers": min_kmers,
            "min_bedgraph_reads": min_bedgraph_reads,
        },
        "regions": [
            {
                "chrom": chrom,
                "start": start,
                "end": end,
                "size": end - start,
                "reads": len(region_reads.get((chrom, start, end), set())),
                "unique_kmers": len(
                    region_kmers.get((chrom, start, end), set())),
                "split_reads": region_annotations.get(
                    (chrom, start, end), {}).get("split_reads", 0),
                "discordant_pairs": region_annotations.get(
                    (chrom, start, end), {}).get("discordant_pairs", 0),
                "max_clip_len": region_annotations.get(
                    (chrom, start, end), {}).get("max_clip_len", 0),
                "unmapped_mates": region_annotations.get(
                    (chrom, start, end), {}).get("unmapped_mates", 0),
                "class": region_annotations.get(
                    (chrom, start, end), {}).get("class", "SMALL"),
            }
            for chrom, start, end in regions
        ],
    }
    if candidate_comparison is not None:
        n_total = len(candidate_comparison)
        n_captured = sum(1 for c in candidate_comparison if c["captured"])
        metrics["candidate_comparison"] = {
            "hq_candidates": n_total,
            "captured": n_captured,
            "capture_rate": (n_captured / n_total) if n_total else 0.0,
            "candidates": [
                {
                    "variant": (f"{c['chrom']}:{c['pos']}"
                                f" {c['ref']}>{c['alt']}"),
                    "dka": c["dka"],
                    "dka_dkt": c["dka_dkt"],
                    "captured": c["captured"],
                    "region": c["region"],
                }
                for c in candidate_comparison
            ],
        }

    dnm_evaluation = _evaluate_dnm_regions(regions, metrics["regions"])
    n_dnm_detected = sum(1 for e in dnm_evaluation if e["detected"])
    logger.info("[Module 4] Curated DNM evaluation: %d / %d detected",
                n_dnm_detected, len(dnm_evaluation))
    metrics["dnm_evaluation"] = {
        "total_loci": len(dnm_evaluation),
        "detected": n_dnm_detected,
        "detection_rate": (n_dnm_detected / len(dnm_evaluation))
        if dnm_evaluation else 0.0,
        "loci": dnm_evaluation,
    }

    if primary:
        with open(metrics_path, "w") as fh:
            json.dump(metrics, fh, indent=2)
        logger.info("[Module 4] Metrics written to: %s", metrics_path)

        logger.info("[Module 4] Writing summary: %s", summary_path)
        _write_discovery_summary(
            summary_path, regions, region_reads, region_kmers, metrics,
            candidate_comparison=candidate_comparison,
            region_annotations=region_annotations,
            dnm_evaluation=dnm_evaluation)
    logger.info("[Module 4] Output complete (%s)",
                format_elapsed(time.monotonic() - step_start))

    report_path = getattr(args, "report", None)
    if report_path and primary:
        logger.info("[Report] Generating interactive HTML report: %s",
                    report_path)
        from kmer_denovo_filter_tpu_torch.report import generate_report
        generate_report(output_path=report_path,
                        discovery_metrics_path=metrics_path,
                        discovery_summary_path=summary_path)

    logger.info("")
    logger.info("=" * 60)
    logger.info("  Discovery pipeline complete!")
    logger.info("=" * 60)
    logger.info("  Candidate regions: %s", bed_path)
    logger.info("  K-mer coverage:    %s", bedgraph_path)
    logger.info("  Read coverage:     %s", read_cov_bed_path)
    logger.info("  Informative BAM:   %s", info_bam_path)
    logger.info("  SV breakpoints:    %s", bedpe_path)
    logger.info("  Metrics:           %s", metrics_path)
    logger.info("  Summary:           %s", summary_path)
    logger.info("")
    logger.info("  Next step: pass %s to a genotyper such as", bed_path)
    logger.info("  GATK HaplotypeCaller (--intervals) or DeepVariant for")
    logger.info("  robust VCF generation.")
    logger.info("=" * 60)
    logger.info("Pipeline finished successfully in %s",
                format_elapsed(time.monotonic() - pipeline_start))


def run_discovery_pipeline(args, device):
    """Run ``kmer-discovery`` with the device work on *device*; honours
    ``KDF_PROFILE=<dir>`` with a ``torch.profiler`` trace around the
    whole run (reference discovery/pipeline.py:1912–1926)."""
    device = eng.resolve_device(device)
    return run_profiled(lambda: _run_discovery_pipeline_impl(args, device),
                        device)
