# Copied from kmer_denovo_filter_tpu/htsio/vcf.py
"""VCF reading and byte-faithful annotation writing.

The reference annotates via a pysam round-trip
(reference vcf/pipeline.py:813–1304).  Because the pysam round-trip of
the input candidate VCF is byte-identical to the input (verified
against tests/example_output/annotated.vcf.gz), this module performs
the annotation as a *text-level transform*: header meta lines are
appended after the existing ``##`` block and the new FORMAT/INFO fields
are appended per data line.  Float values render with C ``%g`` to match
htslib formatting.
"""

import gzip

from kmer_denovo_filter_tpu_torch.htsio.bgzf import BgzfWriter
from kmer_denovo_filter_tpu_torch.htsio.tabix import tabix_index


def _open_text(path):
    if path.endswith(".gz") or path.endswith(".bgz"):
        return gzip.open(path, "rt")
    return open(path)


class VcfRecord:
    __slots__ = ("chrom", "pos", "id", "ref", "alts", "qual", "filter",
                 "info", "format", "sample_values", "line")

    def __init__(self, line, samples):
        self.line = line
        f = line.rstrip("\n").split("\t")
        self.chrom = f[0]
        self.pos = int(f[1])  # 1-based
        self.id = None if f[2] == "." else f[2]
        self.ref = f[3]
        self.alts = None if f[4] == "." else tuple(f[4].split(","))
        self.qual = f[5]
        self.filter = f[6]
        self.info = f[7]
        self.format = f[8] if len(f) > 8 else None
        self.sample_values = f[9:] if len(f) > 9 else []

    @property
    def start(self):
        """0-based start (pysam ``rec.start``)."""
        return self.pos - 1

    def gt(self, sample_index):
        """GT tuple for sample *sample_index* (pysam-style ints/None)."""
        if self.format is None or sample_index >= len(self.sample_values):
            return None
        keys = self.format.split(":")
        if "GT" not in keys:
            return None
        vals = self.sample_values[sample_index].split(":")
        gi = keys.index("GT")
        if gi >= len(vals):
            return None
        gt_str = vals[gi]
        alleles = gt_str.replace("|", "/").split("/")
        out = []
        for a in alleles:
            if a == "." or a == "":
                out.append(None)
            else:
                try:
                    out.append(int(a))
                except ValueError:
                    out.append(None)
        return tuple(out)


class VcfReader:
    """Minimal VCF reader: header, samples, iterate records."""

    def __init__(self, path):
        self.path = path
        self.header_lines = []
        self.samples = []
        self._data_lines = []
        with _open_text(path) as fh:
            for line in fh:
                if line.startswith("##"):
                    self.header_lines.append(line.rstrip("\n"))
                elif line.startswith("#CHROM"):
                    cols = line.rstrip("\n").split("\t")
                    self.samples = cols[9:]
                    self.chrom_line = line.rstrip("\n")
                elif line.strip():
                    self._data_lines.append(line.rstrip("\n"))

    def __iter__(self):
        for line in self._data_lines:
            yield VcfRecord(line, self.samples)

    def close(self):
        pass


def fmt_g(value):
    """Render a float like C ``printf("%g")`` (htslib Float output)."""
    return "%g" % value


# Header meta line templates, matching reference vcf/pipeline.py:852–1183.
_BASE_METAS = [
    ("DKU", "Integer",
     "Number of child fragments (unique read names) with at least one "
     "variant-spanning k-mer unique to child (absent from both parents)"),
    ("DKT", "Integer",
     "Total child fragments (unique read names) with variant-spanning k-mers"),
    ("DKA", "Integer",
     "Number of child fragments (unique read names) with at least one "
     "unique k-mer that also exactly supports the candidate allele"),
    ("DKU_DKT", "Float",
     "Proportion of child fragments with unique k-mers (DKU/DKT)"),
    ("DKA_DKT", "Float",
     "Proportion of child fragments with unique allele-supporting "
     "k-mers (DKA/DKT)"),
    ("MAX_PKC", "Integer",
     "Maximum k-mer count in parents for variant-spanning k-mers"),
    ("AVG_PKC", "Float",
     "Average k-mer count in parents for variant-spanning k-mers found in parents"),
    ("MIN_PKC", "Integer",
     "Minimum k-mer count in parents for variant-spanning k-mers"),
    ("MAX_PKC_ALT", "Integer",
     "Maximum k-mer count in parents for alt-allele-supporting k-mers"),
    ("AVG_PKC_ALT", "Float",
     "Average k-mer count in parents for alt-allele-supporting k-mers found in parents"),
    ("MIN_PKC_ALT", "Integer",
     "Minimum k-mer count in parents for alt-allele-supporting k-mers"),
]

_KRAKEN_METAS = [
    ("DKU_BF", "Float",
     "Fraction of DKU fragments classified as bacterial by "
     "kraken2; denominator equals DKU (both are fragment-based)"),
    ("DKA_BF", "Float",
     "Fraction of DKA fragments classified as bacterial by "
     "kraken2; DKA fragments are always a subset of DKU"),
    ("DKU_AF", "Float",
     "Fraction of DKU fragments classified as archaeal by "
     "kraken2; denominator equals DKU (both are fragment-based)"),
    ("DKA_AF", "Float",
     "Fraction of DKA fragments classified as archaeal by "
     "kraken2; DKA fragments are always a subset of DKU"),
    ("DKU_FF", "Float",
     "Fraction of DKU fragments classified as fungal by "
     "kraken2; denominator equals DKU (both are fragment-based)"),
    ("DKA_FF", "Float",
     "Fraction of DKA fragments classified as fungal by "
     "kraken2; DKA fragments are always a subset of DKU"),
    ("DKU_PF", "Float",
     "Fraction of DKU fragments classified as protist by "
     "kraken2; denominator equals DKU (both are fragment-based)"),
    ("DKA_PF", "Float",
     "Fraction of DKA fragments classified as protist by "
     "kraken2; DKA fragments are always a subset of DKU"),
    ("DKU_VF", "Float",
     "Fraction of DKU fragments classified as viral by "
     "kraken2; denominator equals DKU (both are fragment-based). "
     "Reads with any human k-mer evidence are excluded, which "
     "conservatively handles viruses that integrate into human "
     "DNA (e.g. endogenous retroviruses, HBV, HPV)"),
    ("DKA_VF", "Float",
     "Fraction of DKA fragments classified as viral by "
     "kraken2; DKA fragments are always a subset of DKU"),
    ("DKU_UCF", "Float",
     "Fraction of DKU fragments classified as UniVec Core "
     "(synthetic sequencing-vector/adapter sequences, taxid "
     "81077) by kraken2; denominator equals DKU (both are "
     "fragment-based). Reads with any human k-mer evidence "
     "are excluded. UniVec Core reads are NOT included in "
     "the non-human fraction (DKU_NHF)"),
    ("DKA_UCF", "Float",
     "Fraction of DKA fragments classified as UniVec Core "
     "by kraken2; DKA fragments are always a subset of DKU"),
    ("DKU_NHF", "Float",
     "Fraction of DKU fragments classified as non-human by "
     "kraken2; denominator equals DKU (both are fragment-based). "
     "UniVec Core reads are excluded (see DKU_UCF)"),
    ("DKA_NHF", "Float",
     "Fraction of DKA fragments classified as non-human by "
     "kraken2; DKA fragments are always a subset of DKU. "
     "UniVec Core reads are excluded (see DKA_UCF)"),
    ("DKU_UF", "Float",
     "Fraction of DKU fragments that were unclassified by "
     "kraken2 (no taxonomic assignment). Denominator equals "
     "DKU (both are fragment-based). Together DKU_NHF + "
     "DKU_UCF + DKU_HLF + DKU_UF = 1.0"),
    ("DKA_UF", "Float",
     "Fraction of DKA fragments that were unclassified by "
     "kraken2; DKA fragments are always a subset of DKU. "
     "Together DKA_NHF + DKA_UCF + DKA_HLF + DKA_UF = 1.0"),
    ("DKU_HLF", "Float",
     "Fraction of DKU fragments in the human lineage: "
     "classified reads that are neither definitively "
     "non-human (DKU_NHF) nor UniVec Core (DKU_UCF). "
     "Includes reads directly classified as human, reads "
     "cleared by the human homology guard (HHG), and reads "
     "assigned to broad taxonomic ranks on the human-to-root "
     "path (e.g. Eukaryota, Root). Together DKU_NHF + "
     "DKU_UCF + DKU_HLF + DKU_UF = 1.0"),
    ("DKA_HLF", "Float",
     "Fraction of DKA fragments in the human lineage; "
     "DKA fragments are always a subset of DKU. "
     "Together DKA_NHF + DKA_UCF + DKA_HLF + DKA_UF = 1.0"),
]

# Annotation dict key for each VCF field id, in output order.
_FIELD_KEYS = [
    ("DKU", "dku", int), ("DKT", "dkt", int), ("DKA", "dka", int),
    ("DKU_DKT", "dku_dkt", float), ("DKA_DKT", "dka_dkt", float),
    ("MAX_PKC", "max_pkc", int), ("AVG_PKC", "avg_pkc", float),
    ("MIN_PKC", "min_pkc", int),
    ("MAX_PKC_ALT", "max_pkc_alt", int),
    ("AVG_PKC_ALT", "avg_pkc_alt", float),
    ("MIN_PKC_ALT", "min_pkc_alt", int),
]
_KRAKEN_FIELD_KEYS = [
    ("DKU_BF", "dku_bacterial_fraction"), ("DKA_BF", "dka_bacterial_fraction"),
    ("DKU_AF", "dku_archaeal_fraction"), ("DKA_AF", "dka_archaeal_fraction"),
    ("DKU_FF", "dku_fungal_fraction"), ("DKA_FF", "dka_fungal_fraction"),
    ("DKU_PF", "dku_protist_fraction"), ("DKA_PF", "dka_protist_fraction"),
    ("DKU_VF", "dku_viral_fraction"), ("DKA_VF", "dka_viral_fraction"),
    ("DKU_UCF", "dku_univec_core_fraction"),
    ("DKA_UCF", "dka_univec_core_fraction"),
    ("DKU_NHF", "dku_nonhuman_fraction"), ("DKA_NHF", "dka_nonhuman_fraction"),
    ("DKU_UF", "dku_unclassified_fraction"),
    ("DKA_UF", "dka_unclassified_fraction"),
    ("DKU_HLF", "dku_human_lineage_fraction"),
    ("DKA_HLF", "dka_human_lineage_fraction"),
]


def _select_alt_from_gt(alts, gt):
    """Pick the ALT allele to evaluate from a genotype tuple.

    Mirrors reference vcf/pipeline.py:730–744.
    """
    if gt is None:
        return (alts[0] if alts else None), []
    alt_indices = sorted(set(i for i in gt if i is not None and i > 0))
    if not alt_indices:
        return (alts[0] if alts else None), []
    return alts[alt_indices[0] - 1], alt_indices


def write_annotated_vcf(input_vcf, output_vcf, annotations, proband_id=None):
    """Write the annotated, bgzipped + tabix-indexed output VCF.

    Byte-compatible with the reference pysam implementation
    (reference vcf/pipeline.py:813–1304): FORMAT fields when
    *proband_id* names a VCF sample, INFO fields otherwise.
    Returns the actual output path (with ``.gz`` appended if missing).
    """
    reader = VcfReader(input_vcf)
    has_kraken = any(
        "dku_bacterial_fraction" in ann or "dku_nonhuman_fraction" in ann
        for ann in annotations.values()
    )
    use_format = proband_id is not None and proband_id in reader.samples
    sample_idx = reader.samples.index(proband_id) if use_format else None
    category = "FORMAT" if use_format else "INFO"

    metas = list(_BASE_METAS)
    if has_kraken:
        metas += _KRAKEN_METAS
    meta_lines = [
        f'##{category}=<ID={mid},Number=1,Type={typ},Description="{desc}">'
        for mid, typ, desc in metas
    ]

    field_ids = [fid for fid, _, _ in _FIELD_KEYS]
    if has_kraken:
        field_ids += [fid for fid, _ in _KRAKEN_FIELD_KEYS]

    def values_for(ann):
        vals = []
        for fid, key, typ in _FIELD_KEYS:
            v = ann[key]
            vals.append(str(v) if typ is int else fmt_g(float(v)))
        if has_kraken:
            for fid, key in _KRAKEN_FIELD_KEYS:
                vals.append(fmt_g(float(ann.get(key, 0.0))))
        return vals

    if not output_vcf.endswith(".gz"):
        output_vcf = output_vcf + ".gz"

    out = BgzfWriter(output_vcf)
    try:
        for line in reader.header_lines:
            out.write((line + "\n").encode())
        for m in meta_lines:
            out.write((m + "\n").encode())
        out.write((reader.chrom_line + "\n").encode())
        for rec in reader:
            alt_str = rec.alts[0] if rec.alts else "."
            if use_format and rec.alts and len(rec.alts) > 1:
                gt = rec.gt(sample_idx)
                selected, _ = _select_alt_from_gt(rec.alts, gt)
                alt_str = selected if selected is not None else "."
            var_key = f"{rec.chrom}:{rec.start}:{rec.ref}:{alt_str}"
            fields = rec.line.split("\t")
            if var_key in annotations:
                ann = annotations[var_key]
                vals = values_for(ann)
                if use_format:
                    fields[8] = fields[8] + ":" + ":".join(field_ids)
                    col = 9 + sample_idx
                    fields[col] = fields[col] + ":" + ":".join(vals)
                else:
                    info_add = ";".join(
                        f"{fid}={v}" for fid, v in zip(field_ids, vals))
                    if fields[7] == "." or not fields[7]:
                        fields[7] = info_add
                    else:
                        fields[7] = fields[7] + ";" + info_add
            out.write(("\t".join(fields) + "\n").encode())
    finally:
        out.close()

    tabix_index(output_vcf, preset="vcf", force=True)
    return output_vcf
