# Copied from kmer_denovo_filter_tpu/kraken2_beds.py
"""Kraken2 companion BED outputs (per-read detail + genomic spans).

Port of the three BED writers from reference vcf/pipeline.py:219–616
on top of the package's own bgzf/tabix stack: the per-(variant, read)
classification detail BED, the species-annotated aligned-span BED, and
the soft-clip-expanded span BED.
"""

import logging
import os

from kmer_denovo_filter_tpu_torch.htsio.tabix import tabix_compress, tabix_index
from kmer_denovo_filter_tpu_torch.kraken2 import HUMAN_TAXID

logger = logging.getLogger(__name__)


def parse_kmer_votes(kmer_string, name_map=None, top_n=10):
    """Summarise a kraken2 k-mer detail string into vote columns.

    Returns ``(kmer_votes, kmer_votes_named, total_kmers,
    human_kmer_count)``; taxid 0 renders as ``unclassified`` in the
    named column; ambiguous (``A``) tokens are excluded.
    """
    if not kmer_string:
        return ("", "", 0, 0)
    counts = {}
    for token in kmer_string.replace("|:|", " ").split():
        taxid_str, _, count_str = token.partition(":")
        if not taxid_str or not count_str:
            continue
        try:
            tid = int(taxid_str)
            cnt = int(count_str)
        except ValueError:
            continue
        counts[tid] = counts.get(tid, 0) + cnt
    total_kmers = sum(counts.values())
    human_kmer_count = counts.get(HUMAN_TAXID, 0)
    top = sorted(counts.items(), key=lambda x: (-x[1], x[0]))[:top_n]
    kmer_votes = ";".join(f"{tid}:{cnt}" for tid, cnt in top)

    def _name(tid):
        if tid == 0:
            return "unclassified"
        if name_map and tid in name_map:
            return name_map[tid]
        return str(tid)

    kmer_votes_named = ";".join(f"{_name(tid)}:{cnt}" for tid, cnt in top)
    return (kmer_votes, kmer_votes_named, total_kmers, human_kmer_count)


_DETAIL_COLUMNS = [
    "#chrom", "chromStart", "chromEnd", "variant", "read_name",
    "read_set", "kraken2_status", "assigned_taxid", "assigned_taxon",
    "domain", "guard_status", "is_nonhuman", "kmer_votes",
    "kmer_votes_named", "total_kmers", "human_kmer_count",
]


def write_kraken2_read_detail_bed(output_path,
                                  informative_reads_by_variant,
                                  informative_alt_reads_by_variant,
                                  kraken2_result, name_map):
    """bgzipped + tabix-indexed per-(variant, read) detail BED."""
    row_keys = []
    for var_key in informative_reads_by_variant:
        parts = var_key.split(":")
        if len(parts) < 4:
            continue
        chrom = parts[0]
        try:
            pos = int(parts[1])
        except ValueError:
            continue
        ref = parts[2]
        for rname in informative_reads_by_variant[var_key]:
            row_keys.append((chrom, pos, ref, var_key, rname))
    row_keys.sort(key=lambda x: (x[0], x[1], x[4]))

    raw_path = output_path.replace(".bed.gz", ".bed")
    if raw_path == output_path:
        raw_path = output_path + ".tmp"
    with open(raw_path, "w") as fh:
        fh.write("\t".join(_DETAIL_COLUMNS) + "\n")
        for chrom, pos, ref, var_key, rname in row_keys:
            detail = kraken2_result.per_read_detail.get(rname)
            if detail is None:
                continue
            dka_names = informative_alt_reads_by_variant.get(var_key, set())
            read_set = "DKA" if rname in dka_names else "DKU"
            taxid = detail["taxid"]
            status = detail["status"]
            if status == "U" or taxid == 0:
                assigned_taxon = "."
            elif name_map and taxid in name_map:
                assigned_taxon = name_map[taxid]
            else:
                assigned_taxon = str(taxid)
            votes, votes_named, total_k, human_k = parse_kmer_votes(
                detail["kmer_string"], name_map)
            fields = [
                chrom, str(pos), str(pos + len(ref)), var_key, rname,
                read_set, status, str(taxid), assigned_taxon,
                detail["domain"], detail["guard_status"],
                "true" if detail["is_nonhuman"] else "false",
                votes, votes_named, str(total_k), str(human_k),
            ]
            fh.write("\t".join(fields) + "\n")

    tabix_compress(raw_path, output_path, force=True)
    try:
        os.unlink(raw_path)
    except OSError:
        pass
    tabix_index(output_path, preset="bed", meta_char="#", force=True)


def _extract_softclips(cigartuples):
    from kmer_denovo_filter_tpu_torch.discovery.pipeline import (
        _extract_softclips as impl,
    )
    return impl(cigartuples)


def collect_read_alignment_metadata(bam_reader, read_names,
                                    informative_reads_by_variant=None):
    """Alignment records per informative read (primary + supplementary).

    Port of reference core/bam_scanner.py:137–230 with targeted locus
    fetches when variant→read maps are available.
    """
    if not read_names:
        return {}
    alignment_meta = {}

    def _process(read):
        if read.query_name not in read_names or read.is_unmapped:
            return
        sc_left, sc_right = _extract_softclips(read.cigartuples)
        alignment_meta.setdefault(read.query_name, []).append({
            "chrom": read.reference_name,
            "start": read.reference_start,
            "end": read.reference_end,
            "mapq": read.mapping_quality,
            "softclip_left": sc_left,
            "softclip_right": sc_right,
            "has_sa": read.has_tag("SA"),
            "is_supplementary": read.is_supplementary,
        })

    used_targeted = False
    if informative_reads_by_variant:
        loci_to_names = {}
        for var_key, names in informative_reads_by_variant.items():
            if not names:
                continue
            parts = var_key.split(":")
            if len(parts) < 2:
                continue
            try:
                pos = int(parts[1])
            except ValueError:
                continue
            target = set(names).intersection(read_names)
            if target:
                loci_to_names.setdefault(
                    (parts[0], pos), set()).update(target)
        if loci_to_names:
            used_targeted = True
            seen = set()
            for (chrom, pos), _target in sorted(loci_to_names.items()):
                for read in bam_reader.fetch(chrom, pos, pos + 1):
                    key = (read.query_name, read.is_supplementary,
                           read.reference_start)
                    if key not in seen:
                        seen.add(key)
                        _process(read)
    if not used_targeted:
        for read in bam_reader.fetch(until_eof=True):
            _process(read)
    return alignment_meta


_SPAN_COLUMNS = [
    "#chrom", "start", "end", "taxon_name", "domain",
    "guard_status", "is_nonhuman", "read_name", "variant",
    "read_set", "mapq", "softclip_left", "softclip_right",
    "is_split", "is_supplementary",
]
_EXPANDED_COLUMNS = _SPAN_COLUMNS + ["aligned_start", "aligned_end"]


def _build_span_rows(alignment_meta, informative_reads_by_variant,
                     informative_alt_reads_by_variant, kraken2_result,
                     name_map):
    read_to_variants = {}
    for var_key, names in informative_reads_by_variant.items():
        for rname in names:
            read_to_variants.setdefault(rname, set()).add(var_key)
    dka_reads = set()
    for names in informative_alt_reads_by_variant.values():
        dka_reads.update(names)

    rows = []
    for rname, records in alignment_meta.items():
        detail = kraken2_result.per_read_detail.get(rname)
        if detail is None:
            continue
        var_keys = read_to_variants.get(rname, set())
        if not var_keys:
            continue
        taxid = detail["taxid"]
        if detail["status"] == "U" or taxid == 0:
            taxon_name = "Unclassified"
        elif name_map and taxid in name_map:
            taxon_name = name_map[taxid]
        else:
            taxon_name = f"Unknown_taxid_{taxid}"
        annotation = {
            "taxon_name": taxon_name,
            "domain": detail["domain"],
            "guard_status": detail["guard_status"],
            "is_nonhuman": detail["is_nonhuman"],
            "variant_str": ",".join(sorted(var_keys)),
            "read_set": "DKA" if rname in dka_reads else "DKU",
            "is_split": any(r["has_sa"] for r in records),
            "rname": rname,
        }
        for rec in records:
            rows.append((rec["chrom"], rec["start"], rname,
                         rec["is_supplementary"], rec, annotation))
    rows.sort(key=lambda x: (x[0], x[1], x[2]))
    return rows


def _format_span_row(rec, ann):
    return [
        rec["chrom"], str(rec["start"]), str(rec["end"]),
        ann["taxon_name"], ann["domain"], ann["guard_status"],
        "true" if ann["is_nonhuman"] else "false",
        ann["rname"], ann["variant_str"], ann["read_set"],
        str(rec["mapq"]), str(rec["softclip_left"]),
        str(rec["softclip_right"]),
        "true" if ann["is_split"] else "false",
        "true" if rec["is_supplementary"] else "false",
    ]


def _format_expanded_row(rec, ann):
    expanded_start = max(0, rec["start"] - rec["softclip_left"])
    expanded_end = rec["end"] + rec["softclip_right"]
    return [
        rec["chrom"], str(expanded_start), str(expanded_end),
        ann["taxon_name"], ann["domain"], ann["guard_status"],
        "true" if ann["is_nonhuman"] else "false",
        ann["rname"], ann["variant_str"], ann["read_set"],
        str(rec["mapq"]), str(rec["softclip_left"]),
        str(rec["softclip_right"]),
        "true" if ann["is_split"] else "false",
        "true" if rec["is_supplementary"] else "false",
        str(rec["start"]), str(rec["end"]),
    ]


def _write_bed_from_rows(output_path, columns, rows, format_fn):
    raw_path = output_path.replace(".bed.gz", ".bed")
    if raw_path == output_path:
        raw_path = output_path + ".tmp"
    formatted = [format_fn(rec, ann) for _, _, _, _, rec, ann in rows]
    formatted.sort(key=lambda f: (f[0], int(f[1])))
    with open(raw_path, "w") as fh:
        fh.write("\t".join(columns) + "\n")
        for fields in formatted:
            fh.write("\t".join(fields) + "\n")
    tabix_compress(raw_path, output_path, force=True)
    try:
        os.unlink(raw_path)
    except OSError:
        pass
    tabix_index(output_path, preset="bed", meta_char="#", force=True)


def write_kraken2_span_bed(output_path, alignment_meta,
                           informative_reads_by_variant,
                           informative_alt_reads_by_variant,
                           kraken2_result, name_map):
    """Species-annotated aligned-span BED (one row per alignment)."""
    rows = _build_span_rows(
        alignment_meta, informative_reads_by_variant,
        informative_alt_reads_by_variant, kraken2_result, name_map)
    _write_bed_from_rows(output_path, _SPAN_COLUMNS, rows,
                         _format_span_row)


def write_kraken2_expanded_span_bed(output_path, alignment_meta,
                                    informative_reads_by_variant,
                                    informative_alt_reads_by_variant,
                                    kraken2_result, name_map):
    """Soft-clip-expanded span BED (visualization aid)."""
    rows = _build_span_rows(
        alignment_meta, informative_reads_by_variant,
        informative_alt_reads_by_variant, kraken2_result, name_map)
    _write_bed_from_rows(output_path, _EXPANDED_COLUMNS, rows,
                         _format_expanded_row)
