"""VCF-mode pipeline: annotate candidate variants with k-mer evidence.

Port of :mod:`kmer_denovo_filter_tpu.vcf.pipeline` with the same
five-step contract and byte-identical outputs.  Step 3, the parent
scans, streams every primary read of each parent BAM through the
port's :class:`~kmer_denovo_filter_tpu_torch.engine.FilteredCounter`
on an explicit ``torch.device``: host decode → K1 window extraction →
K2 probe-tally against the child k-mer table.

The host helpers below are copies of the JAX module's (cited at each),
because that module imports ``engine`` and with it jax; the I/O, k-mer
and report code they call is the port's own copy of the JAX package's.
In a multi-host run (``KDF_COORDINATOR``, :mod:`.parallel.multihost`)
each process scans its stripe of each parent BAM, the aligned tallies
sum across processes, and process 0 alone writes the outputs.
``KDF_PROFILE=<dir>`` wraps the run in a ``torch.profiler`` trace
(:mod:`..profiling`).
"""

import collections
import json
import logging
import os
import statistics
import sys
import time

import numpy as np

from kmer_denovo_filter_tpu_torch.htsio.bam import (
    BamWriter,
    open_bam,
    packed_batches,
    resolve_alignment_input,
)
from kmer_denovo_filter_tpu_torch.htsio.vcf import (
    VcfReader,
    _select_alt_from_gt,
    write_annotated_vcf,
)
from kmer_denovo_filter_tpu_torch.kmer import (
    extract_variant_spanning_kmers,
    is_symbolic,
    read_supports_alt,
)
from kmer_denovo_filter_tpu_torch.memory_utils import log_disk_usage
from kmer_denovo_filter_tpu_torch.utils import (
    check_tool,
    format_elapsed,
    format_file_size,
    is_tmpfs,
    prefetch_batches,
    resolve_tmp_dir,
    validate_inputs,
)
from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch.parallel import multihost
from kmer_denovo_filter_tpu_torch.profiling import run_profiled

logger = logging.getLogger(__name__)
_FRACTION_PRECISION = 4

# Copied from kmer_denovo_filter_tpu/vcf/pipeline.py:50–53.
# In-memory dedup-batch threshold mirroring the reference's FASTA flush
# (reference vcf/pipeline.py:623): duplicates are possible across
# flushed batches, and total_child_kmers counts flushed entries.
_FLUSH_THRESHOLD = 500_000


# ── Host helpers copied from kmer_denovo_filter_tpu/vcf/pipeline.py
# (:56–185 and :234–381), unchanged ─────────────────────────────────

def _parse_vcf_variants(vcf_path, proband_id=None):
    """Parse the candidate VCF into variant dicts.

    Mirrors reference vcf/pipeline.py:747–810 including the
    genotype-informed ALT selection for multiallelic records.
    """
    vcf = VcfReader(vcf_path)
    proband_in_vcf = (proband_id is not None and proband_id in vcf.samples)
    sample_idx = vcf.samples.index(proband_id) if proband_in_vcf else None
    variants = []
    for rec in vcf:
        alts = rec.alts
        alt = alts[0] if alts else None
        if alts and len(alts) > 1:
            if proband_in_vcf:
                gt = rec.gt(sample_idx)
                alt, alt_indices = _select_alt_from_gt(alts, gt)
                if len(alt_indices) > 1:
                    gt_str = "/".join(
                        str(i) if i is not None else "." for i in gt)
                    logger.warning(
                        "Multiallelic variant %s:%d — proband is het "
                        "non-ref (%s); only the first non-ref ALT (%s) "
                        "will be evaluated",
                        rec.chrom, rec.pos, gt_str, alt)
                elif alt_indices:
                    logger.info(
                        "Multiallelic variant %s:%d — using proband "
                        "genotype-informed ALT (%s) for evaluation",
                        rec.chrom, rec.pos, alt)
                else:
                    logger.warning(
                        "Multiallelic variant %s:%d has %d ALT alleles; "
                        "only the first ALT (%s) will be evaluated",
                        rec.chrom, rec.pos, len(alts), alt)
            else:
                logger.warning(
                    "Multiallelic variant %s:%d has %d ALT alleles; "
                    "only the first ALT (%s) will be evaluated",
                    rec.chrom, rec.pos, len(alts), alt)
        variants.append({
            "chrom": rec.chrom,
            "pos": rec.start,  # 0-based
            "ref": rec.ref,
            "alts": rec.alts,
            "alt": alt,
            "id": rec.id,
        })
    return variants


def _collect_child_kmers(child_bam_reader, variants, kmer_size, min_baseq,
                         min_mapq, debug_kmers):
    """Step 2: variant-spanning child k-mer extraction.

    Returns ``(total_child_kmers, variant_read_kmers, child_kmers)``
    where *child_kmers* is the list of flushed (batch-deduplicated)
    canonical k-mer strings — the in-memory analog of the reference's
    child_kmers.fa (reference vcf/pipeline.py:619–726, including the
    across-batch duplicate-count semantics of the flush counter).
    """
    batch = set()
    flushed = []
    total_reads_scanned = 0
    variant_read_kmers = {}
    n_variants = len(variants)
    log_interval = max(1, n_variants // 10)
    extract_start = time.monotonic()

    def _flush():
        flushed.extend(batch)
        batch.clear()

    for var_idx, var in enumerate(variants, 1):
        chrom = var["chrom"]
        pos = var["pos"]
        ref = var["ref"]
        alt = var["alt"]
        alt_str = alt if alt is not None else "."
        var_key = f"{chrom}:{pos}:{ref}:{alt_str}"
        if alt is not None and is_symbolic(alt):
            logger.debug("Skipping variant %s:%d with symbolic allele %s",
                         chrom, pos, alt)
            variant_read_kmers[var_key] = []
            continue
        read_kmers = []
        for read in child_bam_reader.fetch(chrom, pos, pos + 1):
            if read.is_unmapped or read.is_secondary or read.is_supplementary:
                continue
            if read.mapping_quality < min_mapq:
                continue
            if read.is_duplicate:
                continue
            ref_end = read.reference_end
            if not (read.reference_start <= pos < (ref_end or 0)):
                continue
            total_reads_scanned += 1
            aligned_pairs = read.get_aligned_pairs(matches_only=False)
            seq = read.query_sequence
            quals = read.query_qualities
            kmers = extract_variant_spanning_kmers(
                read, pos, kmer_size, min_baseq, ref=ref, alt=alt,
                aligned_pairs=aligned_pairs, seq=seq, quals=quals)
            if kmers:
                supports = read_supports_alt(
                    read, pos, ref, alt, min_baseq=min_baseq,
                    aligned_pairs=aligned_pairs, seq=seq, quals=quals)
                read_kmers.append((read.query_name, kmers, supports))
                batch.update(kmers)
                if len(batch) >= _FLUSH_THRESHOLD:
                    _flush()
        variant_read_kmers[var_key] = read_kmers

        if debug_kmers:
            unique = (set().union(*(k for _, k, _ in read_kmers))
                      if read_kmers else set())
            logger.info("Variant %s: %d reads, %d unique k-mers",
                        var_key, len(read_kmers), len(unique))
        if var_idx % log_interval == 0 or var_idx == n_variants:
            elapsed = time.monotonic() - extract_start
            logger.info(
                "[Step 2/5]   Processed %d / %d variants (%.0f%%) — "
                "%d reads scanned, %d k-mers collected (%s)",
                var_idx, n_variants, 100 * var_idx / n_variants,
                total_reads_scanned, len(flushed) + len(batch),
                format_elapsed(elapsed))

    if batch:
        _flush()
    return len(flushed), variant_read_kmers, flushed


def _write_informative_reads(child_bam_reader, informative_reads_by_variant,
                             output_bam):
    """Write DV-tagged informative reads, sorted + BAI-indexed.

    Mirrors reference vcf/pipeline.py:1307–1357 without the
    pysam sort/index subprocess round-trip.
    """
    read_to_variants = {}
    for var_key, read_names in informative_reads_by_variant.items():
        for rname in read_names:
            read_to_variants.setdefault(rname, set()).add(var_key)

    regions = set()
    for var_key in informative_reads_by_variant:
        parts = var_key.split(":")
        regions.add((parts[0], int(parts[1])))

    writer = BamWriter(output_bam, child_bam_reader.header_text,
                       child_bam_reader.refs)
    written = set()
    for chrom, pos in sorted(regions):
        for read in child_bam_reader.fetch(chrom, pos, pos + 1):
            qname = read.query_name
            if qname in read_to_variants and qname not in written:
                read.set_tag("DV", ",".join(sorted(read_to_variants[qname])),
                             value_type="Z")
                writer.write(read)
                written.add(qname)
    writer.close(sort=True, index=True)


def _write_summary(summary_path, variants, annotations):
    """Byte-identical summary text (reference vcf/pipeline.py:1360–1451)."""
    total = len(variants)
    likely_dnm = sum(1 for a in annotations.values() if a["dku"] > 0)
    inherited = total - likely_dnm

    cols = ["dku", "dkt", "dka", "dku_dkt", "dka_dkt", "max_pkc",
            "avg_pkc", "min_pkc", "max_pkc_alt", "avg_pkc_alt",
            "min_pkc_alt"]
    vals = {c: [a[c] for a in annotations.values()] for c in cols}
    dnm_dku = [a["dku"] for a in annotations.values() if a["dku"] > 0]

    lines = []
    lines.append("=" * 60)
    lines.append("  kmer-denovo  —  De Novo Variant Summary")
    lines.append("=" * 60)
    lines.append("")
    lines.append("Variant Counts")
    lines.append("-" * 40)
    lines.append(f"  Total candidates analyzed:   {total:>6}")
    lines.append(f"  Likely de novo (DKU > 0):    {likely_dnm:>6}")
    lines.append(f"  Inherited / unclear (DKU=0): {inherited:>6}")
    lines.append("")

    if vals["dku"]:
        def mean(c):
            return sum(vals[c]) / len(vals[c])
        lines.append("Read Support Statistics")
        lines.append("-" * 40)
        lines.append(
            f"  DKU  mean:   {mean('dku'):>6.1f}   "
            f"median: {statistics.median(vals['dku']):>4}")
        lines.append(f"  DKT  mean:   {mean('dkt'):>6.1f}")
        lines.append(f"  DKA  mean:   {mean('dka'):>6.1f}")
        lines.append(f"  DKU_DKT  mean: {mean('dku_dkt'):>6.4f}")
        lines.append(f"  DKA_DKT  mean: {mean('dka_dkt'):>6.4f}")
        lines.append(f"  MAX_PKC  mean: {mean('max_pkc'):>6.1f}")
        lines.append(f"  AVG_PKC  mean: {mean('avg_pkc'):>6.1f}")
        lines.append(f"  MIN_PKC  mean: {mean('min_pkc'):>6.1f}")
        lines.append(f"  MAX_PKC_ALT  mean: {mean('max_pkc_alt'):>6.1f}")
        lines.append(f"  AVG_PKC_ALT  mean: {mean('avg_pkc_alt'):>6.1f}")
        lines.append(f"  MIN_PKC_ALT  mean: {mean('min_pkc_alt'):>6.1f}")
        lines.append("")

    if dnm_dku:
        lines.append(
            f"  Avg DKU among likely DNMs:   "
            f"{sum(dnm_dku) / len(dnm_dku):>6.1f}")
        lines.append("")

    lines.append("Per-Variant Results")
    lines.append("-" * 120)
    lines.append(f"  {'Variant':<30s} {'DKU':>5s} {'DKT':>5s} {'DKA':>5s} {'DKU_DKT':>8s} {'DKA_DKT':>8s} {'MAX_PKC':>8s} {'AVG_PKC':>8s} {'MIN_PKC':>8s} {'MAX_PKC_ALT':>12s} {'AVG_PKC_ALT':>12s} {'MIN_PKC_ALT':>12s}  Call")
    lines.append(f"  {'-------':<30s} {'---':>5s} {'---':>5s} {'---':>5s} {'-------':>8s} {'-------':>8s} {'-------':>8s} {'-------':>8s} {'-------':>8s} {'-----------':>12s} {'-----------':>12s} {'-----------':>12s}  ----")

    empty = {"dku": 0, "dkt": 0, "dka": 0, "dku_dkt": 0.0, "dka_dkt": 0.0,
             "max_pkc": 0, "avg_pkc": 0.0, "min_pkc": 0, "max_pkc_alt": 0,
             "avg_pkc_alt": 0.0, "min_pkc_alt": 0}
    for var in variants:
        ref = var["ref"]
        alts = var["alts"]
        alt = var.get("alt") if var.get("alt") is not None else (
            alts[0] if alts else ".")
        var_key = f"{var['chrom']}:{var['pos']}:{ref}:{alt}"
        ann = annotations.get(var_key, empty)
        label = f"{var['chrom']}:{var['pos'] + 1} {ref}>{alt}"
        call = "DE_NOVO" if ann["dku"] > 0 else "inherited"
        lines.append(f"  {label:<30s} {ann['dku']:>5d} {ann['dkt']:>5d} {ann['dka']:>5d} {ann['dku_dkt']:>8.4f} {ann['dka_dkt']:>8.4f} {ann['max_pkc']:>8d} {ann['avg_pkc']:>8.2f} {ann['min_pkc']:>8d} {ann['max_pkc_alt']:>12d} {ann['avg_pkc_alt']:>12.2f} {ann['min_pkc_alt']:>12d}  {call}")

    lines.append("")
    lines.append("=" * 60)
    lines.append("")
    text = "\n".join(lines)
    with open(summary_path, "w") as fh:
        fh.write(text)
    return text


def _fold_variant_reads(read_kmers_list, parent_kmer_set):
    """Fold one variant's spanning reads into fragment sets + k-mer pools.

    Fragment granularity: paired mates share a query name and count
    once.  A fragment is *informative* when any of its alignments
    carries a spanning k-mer absent from both parents (reference
    vcf/pipeline.py:1667–1686).

    Returns ``(spanning, informative, informative_alt, kmer_pool,
    alt_kmer_pool)`` — three fragment-name sets and the union of
    spanning / alt-supporting k-mers across all reads.
    """
    spanning, informative, informative_alt = set(), set(), set()
    kmer_pool, alt_kmer_pool = set(), set()
    for read_name, kmers, supports_alt in read_kmers_list:
        spanning.add(read_name)
        kmer_pool |= kmers
        novel = not kmers <= parent_kmer_set
        if novel:
            informative.add(read_name)
        if supports_alt:
            alt_kmer_pool |= kmers
            if novel:
                informative_alt.add(read_name)
    return spanning, informative, informative_alt, kmer_pool, alt_kmer_pool


def _parent_count_stats(kmer_pool, parent_found_kmers):
    """(max, mean, min) parent counts over the pool's parent-seen k-mers.

    Mean is rounded to 2 decimals (the reference's metric format,
    vcf/pipeline.py:1699–1717); an empty intersection yields (0, 0.0, 0).
    """
    counts = [parent_found_kmers[km] for km in kmer_pool
              if km in parent_found_kmers]
    if not counts:
        return 0, 0.0, 0
    return max(counts), round(statistics.mean(counts), 2), min(counts)


def _scan_parent_device(parent_bam_path, child_index, label,
                        stripe=None):
    """Step 3: filtered parent count on the child index's device.

    Port of kmer_denovo_filter_tpu/vcf/pipeline.py:194.  Streams all
    primary, non-duplicate, non-supplementary parent reads (flag filter
    0xD00, matching ``samtools fasta -F 0xD00`` at reference
    core/jellyfish_wrappers.py:159) through the filtered counter.
    Returns ``{canonical_kmer: parent_count}`` for count >= 1 (the
    ``jellyfish dump -c -L 1`` contract).

    With ``stripe=(h, n)`` each process counts its input shard of the
    parent BAM; the aligned tallies sum across processes.
    """
    scan_start = time.monotonic()
    logger.info("Scanning parent BAM (%s): %s",
                format_file_size(parent_bam_path), parent_bam_path)
    logger.info("  device filtered count (k=%d, table=%d k-mers, %s)",
                child_index.k, child_index.n, child_index.device)
    fc = eng.make_filtered_counter(child_index)
    n_reads = 0
    for codes, lengths in prefetch_batches(
            packed_batches(parent_bam_path, exclude_flags=0xD00,
                           stripe=stripe)):
        fc.feed(codes, lengths)
        n_reads += codes.shape[0]
    counts = fc.result()
    if stripe is not None:
        counts = multihost.sum_aligned(counts)
        n_reads = int(multihost.sum_aligned(np.int64(n_reads)))
    strings = child_index.to_strings()
    found = {s: int(c) for s, c in zip(strings, counts) if c > 0}
    logger.info("  %s scan complete — %d reads, %d k-mers found (%s)",
                label, n_reads, len(found),
                format_elapsed(time.monotonic() - scan_start))
    return found


def _run_pipeline_impl(args, device):
    """Run the five-step VCF annotation pipeline.

    Follows kmer_denovo_filter_tpu/vcf/pipeline.py:383–784 step for
    step; the parent scans run on *device*.
    """
    pipeline_start = time.monotonic()
    logging.basicConfig(
        level=logging.DEBUG if args.debug_kmers else logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s")

    # ── Pre-flight ─────────────────────────────────────────────────
    kraken2_db = getattr(args, "kraken2_db", None)
    kraken2_confidence = getattr(args, "kraken2_confidence", 0.0)
    kraken2_memory_mapping = getattr(args, "kraken2_memory_mapping", False)
    if kraken2_db is not None:
        if not check_tool("kraken2"):
            logger.error("kraken2 not found in PATH (required by --kraken2-db)")
            sys.exit(1)
        if not os.path.isdir(kraken2_db):
            logger.error("Kraken2 database not found: %s", kraken2_db)
            sys.exit(1)

    validate_inputs(args)

    # Multi-host deployment (KDF_COORDINATOR env / N processes): the
    # parent scans stream per-process input stripes and merge; process
    # 0 alone runs the optional Kraken2 stage and writes outputs.
    stripe = multihost.stripe()
    primary = multihost.is_primary()
    if stripe is not None:
        logger.info("  Multi-host run: process %d of %d (input stripe)",
                    stripe[0], stripe[1])

    logger.info("=" * 60)
    logger.info("  kmer-denovo  —  pipeline starting")
    logger.info("=" * 60)
    logger.info("  Child BAM/CRAM:    %s (%s)", args.child,
                format_file_size(args.child))
    logger.info("  Mother BAM/CRAM:   %s (%s)", args.mother,
                format_file_size(args.mother))
    logger.info("  Father BAM/CRAM:   %s (%s)", args.father,
                format_file_size(args.father))
    logger.info("  Input VCF:         %s", args.vcf)
    logger.info("  Output VCF:        %s", args.output)
    logger.info("  Reference FASTA:   %s", args.ref_fasta or "(not set)")
    logger.info("  k-mer size:        %d", args.kmer_size)
    logger.info("  Min base quality:  %d", args.min_baseq)
    logger.info("  Min mapping qual:  %d", args.min_mapq)
    logger.info("  Threads:           %d", args.threads)
    memory_limit_gb = getattr(args, "memory", None)
    logger.info("  Memory limit:      %s",
                f"{memory_limit_gb:.1f} GB" if memory_limit_gb is not None
                else "(auto-detect)")
    logger.info("  Proband ID:        %s", args.proband_id or "(not set)")
    logger.info("  Kraken2 DB:        %s", kraken2_db or "(disabled)")
    logger.info("  Device:            %s", device)
    logger.info("=" * 60)
    # resource flags tune the host side of the engine: --threads sizes
    # the BGZF inflation pool, --memory the stream-counter merge floor
    # (explicit env vars win)
    os.environ.setdefault("KDF_BGZF_THREADS", str(args.threads))
    if memory_limit_gb is not None:
        os.environ.setdefault(
            "KDF_MERGE_ROWS", str(int(memory_limit_gb * 8) << 20))

    # CRAM inputs: convert once up front so every downstream consumer
    # (streaming packed batches, BAI fetch, native inflate) sees BAM
    for _attr in ("child", "mother", "father"):
        _p = getattr(args, _attr)
        _rp = resolve_alignment_input(_p, args.ref_fasta)
        if _rp != _p:
            logger.info("CRAM input converted: %s -> %s", _p, _rp)
            setattr(args, _attr, _rp)

    # ── Step 1: Parse VCF ──────────────────────────────────────────
    step_start = time.monotonic()
    logger.info("[Step 1/5] Parsing VCF: %s", args.vcf)
    variants = _parse_vcf_variants(args.vcf, proband_id=args.proband_id)
    logger.info("[Step 1/5] Found %d candidate variants (%s)",
                len(variants), format_elapsed(time.monotonic() - step_start))

    if not variants:
        logger.warning("No variants found in VCF; writing empty output")
        if primary:
            write_annotated_vcf(args.vcf, args.output, {}, args.proband_id)
            if args.metrics:
                with open(args.metrics, "w") as fh:
                    json.dump({"total_variants": 0}, fh, indent=2)
        logger.info("Pipeline finished in %s",
                    format_elapsed(time.monotonic() - pipeline_start))
        return

    # ── Step 2: Extract child k-mers ───────────────────────────────
    step_start = time.monotonic()
    logger.info("[Step 2/5] Extracting child k-mers from %d variants (k=%d)",
                len(variants), args.kmer_size)

    out_dir = os.path.dirname(os.path.abspath(args.output)) or "."
    tmp_root = resolve_tmp_dir(args.tmp_dir, out_dir)
    logger.info("  Temp directory root: %s", tmp_root)
    if is_tmpfs(tmp_root):
        logger.warning(
            "  ⚠ Temp directory %s appears to be on tmpfs (RAM-backed)! "
            "Consider using --tmp-dir to point to a disk-backed filesystem.",
            tmp_root)
    log_disk_usage(tmp_root, "tmpdir filesystem")

    child_bam_reader = open_bam(args.child, reference_filename=args.ref_fasta)
    total_child_kmers, variant_read_kmers, child_kmer_list = (
        _collect_child_kmers(child_bam_reader, variants, args.kmer_size,
                             args.min_baseq, args.min_mapq, args.debug_kmers))
    logger.info(
        "[Step 2/5] Wrote %d child k-mers — partially deduplicated (%s)",
        total_child_kmers, format_elapsed(time.monotonic() - step_start))

    # ── Step 3: Scan parents on device ─────────────────────────────
    step_start = time.monotonic()
    parent_found_kmers = collections.Counter()
    if total_child_kmers == 0:
        logger.info("[Step 3/5] No child k-mers found; skipping parent scans")
    else:
        logger.info("[Step 3/5] Scanning parent BAMs for %d child k-mers",
                    total_child_kmers)
        child_index = eng.KmerIndex.from_strings(
            set(child_kmer_list), args.kmer_size, device=device)

        parent_start = time.monotonic()
        logger.info("[Step 3/5] ── Mother scan (1/2) ──")
        mother_kmers = _scan_parent_device(args.mother, child_index,
                                           "Mother", stripe=stripe)
        parent_found_kmers.update(mother_kmers)
        logger.info(
            "[Step 3/5] Mother done — %d / %d child k-mers found in "
            "mother (%s)", len(mother_kmers), total_child_kmers,
            format_elapsed(time.monotonic() - parent_start))

        parent_start = time.monotonic()
        logger.info("[Step 3/5] ── Father scan (2/2) ──")
        father_kmers = _scan_parent_device(args.father, child_index,
                                           "Father", stripe=stripe)
        parent_found_kmers.update(father_kmers)
        logger.info(
            "[Step 3/5] Father done — %d / %d child k-mers found in "
            "father (%s)", len(father_kmers), total_child_kmers,
            format_elapsed(time.monotonic() - parent_start))

        logger.info(
            "[Step 3/5] Parent scanning complete — %d distinct "
            "child k-mers found across parents (%s)",
            len(parent_found_kmers),
            format_elapsed(time.monotonic() - step_start))

    child_unique_kmers = max(0, total_child_kmers - len(parent_found_kmers))

    try:
        if not getattr(args, "tmp_dir", None) and os.path.isdir(tmp_root):
            os.rmdir(tmp_root)
    except OSError:
        pass

    logger.info(
        "Child-unique k-mers (approx): %d / %d (%.1f%% unique)",
        child_unique_kmers, total_child_kmers,
        100 * child_unique_kmers / total_child_kmers
        if total_child_kmers else 0)

    # ── Step 4: Annotate variants ──────────────────────────────────
    step_start = time.monotonic()
    logger.info("[Step 4/5] Annotating %d variants with k-mer evidence",
                len(variants))
    annotations = {}
    informative_reads_by_variant = {}
    informative_alt_reads_by_variant = {}
    n_variants = len(variants)
    log_interval = max(1, n_variants // 10)
    running_dnm = 0
    running_reads = 0

    parent_kmer_set = set(parent_found_kmers)
    logger.info("[Step 4/5] Parent k-mer lookup set: %d entries",
                len(parent_kmer_set))

    for idx, var in enumerate(variants, 1):
        alt = "." if var["alt"] is None else var["alt"]
        var_key = f"{var['chrom']}:{var['pos']}:{var['ref']}:{alt}"
        (spanning, informative, informative_alt, kmer_pool,
         alt_kmer_pool) = _fold_variant_reads(
            variant_read_kmers.get(var_key, []), parent_kmer_set)

        dkt, dku, dka = len(spanning), len(informative), len(informative_alt)
        running_reads += dkt
        running_dnm += 1 if dku else 0

        max_pkc, avg_pkc, min_pkc = _parent_count_stats(
            kmer_pool, parent_found_kmers)
        max_pkc_alt, avg_pkc_alt, min_pkc_alt = _parent_count_stats(
            alt_kmer_pool, parent_found_kmers)

        annotations[var_key] = {
            "dku": dku, "dkt": dkt, "dka": dka,
            "dku_dkt": round(dku / dkt, 4) if dkt else 0.0,
            "dka_dkt": round(dka / dkt, 4) if dkt else 0.0,
            "max_pkc": max_pkc, "avg_pkc": avg_pkc, "min_pkc": min_pkc,
            "max_pkc_alt": max_pkc_alt, "avg_pkc_alt": avg_pkc_alt,
            "min_pkc_alt": min_pkc_alt,
        }
        if informative:
            informative_reads_by_variant[var_key] = informative
        if informative_alt:
            informative_alt_reads_by_variant[var_key] = informative_alt

        if args.debug_kmers:
            logger.info("Variant %s: DKU=%d DKT=%d DKA=%d",
                        var_key, dku, dkt, dka)
        if idx % log_interval == 0 or idx == n_variants:
            elapsed = time.monotonic() - step_start
            rate = idx / elapsed if elapsed > 0 else 0
            eta = (n_variants - idx) / rate if rate > 0 else 0
            logger.info(
                "[Step 4/5]   %d / %d variants (%.0f%%) — "
                "%d de novo so far, %d total reads "
                "(%.0f var/s, %s elapsed, ~%s remaining)",
                idx, n_variants, 100 * idx / n_variants,
                running_dnm, running_reads, rate,
                format_elapsed(elapsed), format_elapsed(eta))

    likely_dnm = running_dnm
    logger.info(
        "[Step 4/5] Annotation complete — %d likely de novo, "
        "%d inherited (%s)", likely_dnm, n_variants - likely_dnm,
        format_elapsed(time.monotonic() - step_start))

    if not primary:
        # non-primary processes contributed their parent-scan stripes;
        # the optional Kraken2 stage and all output writing belong to
        # process 0
        logger.info("Pipeline finished successfully in %s "
                    "(multi-host worker %d; outputs written by "
                    "process 0)",
                    format_elapsed(time.monotonic() - pipeline_start),
                    stripe[0])
        return

    # ── Kraken2 stage (optional) ───────────────────────────────────
    kraken2_result = None
    name_map = None
    all_informative_names = set()
    if kraken2_db is not None:
        from kmer_denovo_filter_tpu_torch.kraken2 import (
            Kraken2Runner,
            run_kraken2_on_reads,
        )
        step_start = time.monotonic()
        for names in informative_reads_by_variant.values():
            all_informative_names.update(names)
        logger.info(
            "[Kraken2] Classifying %d informative reads for "
            "non-human content", len(all_informative_names))
        kraken2_result = run_kraken2_on_reads(
            args.child, args.ref_fasta, all_informative_names, kraken2_db,
            confidence=kraken2_confidence, threads=args.threads,
            informative_reads_by_variant=informative_reads_by_variant,
            memory_mapping=kraken2_memory_mapping)
        logger.info("[Kraken2] %s (%s)", kraken2_result.summary(),
                    format_elapsed(time.monotonic() - step_start))
        name_map = Kraken2Runner.load_name_map(kraken2_db)

        from kmer_denovo_filter_tpu_torch.kraken2 import TALLY_CATEGORIES

        # Per-variant contamination fractions (ref vcf/pipeline.py:
        # 1782–1807): for each classification category, the share of
        # the variant's DKU/DKA fragments that kraken2 put there.
        # Annotation key order (clades, nonhuman, unclassified,
        # human_lineage) is pinned by the VCF INFO field layout.
        fraction_labels = (TALLY_CATEGORIES[:-1]
                           + ("unclassified", "human_lineage"))
        for var_key, ann in annotations.items():
            dku_names = informative_reads_by_variant.get(var_key, set())
            dka_names = informative_alt_reads_by_variant.get(var_key, set())
            for label in fraction_labels:
                classified = getattr(kraken2_result,
                                     f"{label}_read_names")
                for prefix, frag_names in (("dku", dku_names),
                                           ("dka", dka_names)):
                    ann[f"{prefix}_{label}_fraction"] = (
                        round(len(frag_names & classified)
                              / len(frag_names), _FRACTION_PRECISION)
                        if frag_names else 0.0)

    # ── Step 5: Outputs ────────────────────────────────────────────
    step_start = time.monotonic()
    logger.info("[Step 5/5] Writing output files")
    logger.info("[Step 5/5] Writing annotated VCF: %s", args.output)
    actual_output = write_annotated_vcf(
        args.vcf, args.output, annotations, args.proband_id)

    if args.informative_reads:
        logger.info("[Step 5/5] Writing informative reads BAM: %s",
                    args.informative_reads)
        _write_informative_reads(
            child_bam_reader, informative_reads_by_variant,
            args.informative_reads)
        total_reads = sum(len(n) for n in
                          informative_reads_by_variant.values())
        logger.info("[Step 5/5] Wrote %d informative reads across "
                    "%d variants", total_reads,
                    len(informative_reads_by_variant))

    if kraken2_result is not None:
        from kmer_denovo_filter_tpu_torch.kraken2_beds import (
            collect_read_alignment_metadata,
            write_kraken2_expanded_span_bed,
            write_kraken2_read_detail_bed,
            write_kraken2_span_bed,
        )
        detail_path = getattr(args, "kraken2_read_detail", None)
        if detail_path is None:
            base = args.output
            for ext in (".vcf.gz", ".vcf.bgz", ".vcf"):
                if base.endswith(ext):
                    base = base[:-len(ext)]
                    break
            detail_path = base + ".kraken2_reads.bed.gz"
        logger.info("[Step 5/5] Writing per-read Kraken2 detail BED: %s",
                    detail_path)
        write_kraken2_read_detail_bed(
            detail_path, informative_reads_by_variant,
            informative_alt_reads_by_variant, kraken2_result, name_map)

        span_path = getattr(args, "kraken2_span_bed", None)
        if span_path is None:
            base = args.output
            for ext in (".vcf.gz", ".vcf.bgz", ".vcf"):
                if base.endswith(ext):
                    base = base[:-len(ext)]
                    break
            span_path = base + ".kraken2_spans.bed.gz"
        logger.info("[Step 5/5] Collecting alignment metadata for span BED")
        alignment_meta = collect_read_alignment_metadata(
            child_bam_reader, all_informative_names,
            informative_reads_by_variant=informative_reads_by_variant)
        logger.info("[Step 5/5] Writing species-annotated span BED: %s",
                    span_path)
        write_kraken2_span_bed(
            span_path, alignment_meta, informative_reads_by_variant,
            informative_alt_reads_by_variant, kraken2_result, name_map)
        if not getattr(args, "no_expanded_bed", False):
            expanded_path = span_path.replace(
                ".kraken2_spans.bed.gz", ".kraken2_spans_expanded.bed.gz")
            if expanded_path == span_path:
                expanded_path = span_path.replace(
                    ".bed.gz", "_expanded.bed.gz")
            logger.info("[Step 5/5] Writing expanded span BED: %s",
                        expanded_path)
            write_kraken2_expanded_span_bed(
                expanded_path, alignment_meta, informative_reads_by_variant,
                informative_alt_reads_by_variant, kraken2_result, name_map)

    if args.metrics:
        metrics = {
            "total_variants": len(variants),
            "total_child_kmers": total_child_kmers,
            "parent_found_kmers": len(parent_found_kmers),
            "child_unique_kmers": child_unique_kmers,
            "variants_with_unique_reads": likely_dnm,
        }
        if kraken2_result is not None:
            metrics["kraken2"] = {
                "total_reads_classified": kraken2_result.total,
                "classified": kraken2_result.classified,
                "unclassified": kraken2_result.unclassified,
                "bacterial_reads": kraken2_result.bacterial_count,
                "archaeal_reads": kraken2_result.archaeal_count,
                "fungal_reads": kraken2_result.fungal_count,
                "protist_reads": kraken2_result.protist_count,
                "viral_reads": kraken2_result.viral_count,
                "univec_core_reads": kraken2_result.univec_core_count,
                "nonhuman_reads": kraken2_result.nonhuman_count,
                "human_reads": kraken2_result.human_count,
                "root_reads": kraken2_result.root_count,
                "bacterial_fraction": kraken2_result.bacterial_fraction,
            }
        with open(args.metrics, "w") as fh:
            json.dump(metrics, fh, indent=2)
        logger.info("[Step 5/5] Metrics written to: %s", args.metrics)

    if args.summary:
        logger.info("[Step 5/5] Writing summary: %s", args.summary)
        _write_summary(args.summary, variants, annotations)

    report_path = getattr(args, "report", None)
    if report_path:
        logger.info("[Report] Generating interactive HTML report: %s",
                    report_path)
        from kmer_denovo_filter_tpu_torch.report import generate_report
        generate_report(output_path=report_path,
                        vcf_metrics_path=args.metrics,
                        vcf_summary_path=args.summary,
                        vcf_path=actual_output)

    logger.info("[Step 5/5] Output complete (%s)",
                format_elapsed(time.monotonic() - step_start))
    logger.info("Pipeline finished successfully in %s",
                format_elapsed(time.monotonic() - pipeline_start))


def run_pipeline(args, device):
    """Run ``kmer-denovo`` with the parent scans on *device*; honours
    ``KDF_PROFILE=<dir>`` with a ``torch.profiler`` trace around the
    whole run (reference vcf/pipeline.py:786–800)."""
    device = eng.resolve_device(device)
    return run_profiled(lambda: _run_pipeline_impl(args, device), device)
