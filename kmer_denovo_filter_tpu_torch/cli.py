"""Command-line interface of the port: ``kmer-denovo-torch``,
``kmer-discovery-torch``, ``kmer-report-torch`` and the legacy combined
command (``python -m kmer_denovo_filter_tpu_torch``, :func:`main`).

Flag-compatible with ``kmer-denovo`` / ``kmer-discovery`` /
``kmer-report``: the parsers and ``report_main`` below are copied from
the JAX package.  Every pipeline runs its device work on CUDA unless
the caller passes ``device="cpu"`` (the tests do); there is no CPU
fallback.  With ``KDF_COORDINATOR`` / ``KDF_NUM_PROCESSES`` /
``KDF_PROCESS_ID`` set, each entry point first joins an N-process run
(:func:`_join_multihost`).
"""

import argparse
import sys

import torch


# Copied from kmer_denovo_filter_tpu/cli.py:12–234 (_add_shared_args,
# parse_vcf_args, _add_discovery_args, parse_discovery_args, parse_args).

def _add_shared_args(parser):
    """Arguments common to both pipelines (reference cli.py:10–65)."""
    parser.add_argument(
        "--child", required=True, help="Child BAM/CRAM file (indexed)")
    parser.add_argument(
        "--mother", required=True, help="Mother BAM/CRAM file (indexed)")
    parser.add_argument(
        "--father", required=True, help="Father BAM/CRAM file (indexed)")
    parser.add_argument(
        "--ref-fasta", "-r", default=None,
        help="Reference FASTA with .fai index (required for CRAM input; "
             "also required for kmer-discovery unless --ref-jf is provided)")
    parser.add_argument(
        "--kmer-size", "-k", type=int, default=31,
        help="K-mer size (default: 31)")
    parser.add_argument(
        "--min-baseq", type=int, default=20,
        help="Minimum base quality for read k-mers (default: 20)")
    parser.add_argument(
        "--threads", "-t", type=int, default=4,
        help="Number of host worker threads (default: 4)")
    parser.add_argument(
        "--memory", type=float, default=None,
        help="Available memory in GB. On HPC systems (e.g. SLURM), set "
             "this to the allocated memory so batch sizes are tuned "
             "correctly. When omitted, auto-detected from the system.")
    parser.add_argument(
        "--debug-kmers", action="store_true", default=False,
        help="Enable per-variant debug output")
    parser.add_argument(
        "--jf-hash-size", default=None,
        help="Accepted for reference-CLI compatibility; the device "
             "engine sizes its tables automatically.")
    parser.add_argument(
        "--tmp-dir", default=None,
        help="Directory for temporary files. Defaults to a subdirectory "
             "next to the output files.")


def parse_vcf_args(argv=None):
    """Parser for the VCF annotation pipeline (kmer-denovo)."""
    parser = argparse.ArgumentParser(
        prog="kmer-denovo",
        description="De novo variant curation using k-mer analysis "
                    "(VCF mode)")
    _add_shared_args(parser)
    parser.add_argument("--vcf", required=True,
                        help="Input VCF with candidate variants")
    parser.add_argument("--output", "-o", required=True,
                        help="Output annotated VCF")
    parser.add_argument("--metrics", default=None,
                        help="Output summary metrics JSON file")
    parser.add_argument(
        "--summary", default=None,
        help="Output human-readable summary of variant stats and "
             "likely DNMs")
    parser.add_argument(
        "--informative-reads", default=None,
        help="Output BAM with reads carrying informative (child-unique) "
             "k-mers for IGV visualization")
    parser.add_argument(
        "--min-mapq", type=int, default=20,
        help="Minimum mapping quality for child reads (default: 20)")
    parser.add_argument(
        "--proband-id", default=None,
        help="Sample ID of the proband in the VCF. When provided and "
             "matching a VCF sample, DKU/DKT/DKA are written as FORMAT "
             "fields on that sample; otherwise they are written as INFO "
             "fields.")
    parser.add_argument(
        "--kraken2-db", default=None,
        help="Path to a Kraken2 database for non-human content "
             "classification. Requires kraken2 on PATH.")
    parser.add_argument(
        "--kraken2-confidence", type=float, default=0.0,
        help="Kraken2 confidence threshold (0.0–1.0) for LCA "
             "classification (default: 0.0)")
    parser.add_argument(
        "--kraken2-memory-mapping", action="store_true", default=False,
        help="Enable Kraken2 --memory-mapping to reduce RAM usage")
    parser.add_argument(
        "--kraken2-read-detail", default=None,
        help="Output path for the per-read Kraken2 classification detail "
             "BED (bgzipped + tabix-indexed); auto-derived from --output "
             "when omitted.")
    parser.add_argument(
        "--kraken2-span-bed", default=None,
        help="Output path for the species-annotated genomic span BED "
             "(bgzipped + tabix-indexed); auto-derived from --output "
             "when omitted.")
    parser.add_argument(
        "--no-expanded-bed", action="store_true", default=False,
        help="Disable the soft-clip-expanded span BED output")
    parser.add_argument(
        "--report", default=None,
        help="Output path for a self-contained interactive HTML report")
    return parser.parse_args(argv)


def _add_discovery_args(parser):
    parser.add_argument(
        "--save-proband-index", action="store_true",
        help="After parent filtering, write the proband-unique k-mer "
             "index to [out-prefix].proband_unique.kdx.npz so later "
             "runs can resume Modules 3+ with --proband-index")
    parser.add_argument(
        "--proband-index", default=None,
        help="Resume from a proband-unique index snapshot (skips "
             "Modules 0-2: counting, reference subtraction, parent "
             "filtering)")
    parser.add_argument(
        "--ref-jf", default=None,
        help="Path to a precomputed reference k-mer index (jellyfish "
             "binary/sorted .jf or this tool's .kdx.npz). Defaults to "
             "[ref-fasta].k[kmer-size].kdx.npz")
    parser.add_argument(
        "--min-child-count", type=int, default=3,
        help="Minimum child k-mer occurrences (default: 3)")
    parser.add_argument(
        "--candidate-summary", default=None,
        help="Path to a VCF-mode summary.txt for candidate comparison. "
             "High-quality de novos (DKA_DKT > 0.25, DKA > 10) are "
             "checked against discovered regions.")
    parser.add_argument(
        "--cluster-distance", type=int, default=500,
        help="Maximum gap (bp) for merging adjacent regions "
             "(default: 500)")
    parser.add_argument(
        "--min-supporting-reads", type=int, default=1,
        help="Minimum number of supporting reads per region (default: 1)")
    parser.add_argument(
        "--min-distinct-kmers", type=int, default=1,
        help="Minimum number of distinct proband-unique k-mers per "
             "region (default: 1)")
    parser.add_argument(
        "--min-bedgraph-reads", type=int, default=3,
        help="Minimum number of distinct reads with at least one de novo "
             "k-mer at a position for bedGraph/read-coverage output "
             "(default: 3)")
    parser.add_argument(
        "--min-distinct-kmers-per-read", type=int, default=None,
        help="Minimum distinct proband-unique k-mers a read must carry "
             "to be retained (default: k/4)")
    parser.add_argument(
        "--parent-max-count", type=int, default=0,
        help="Maximum k-mer count in a parent before the k-mer is "
             "considered parental (default: 0)")
    parser.add_argument(
        "--sv-bedpe", default=None,
        help="Output BEDPE for linked SV breakpoint pairs "
             "(default: [out-prefix].sv.bedpe)")
    parser.add_argument(
        "--report", default=None,
        help="Output path for a self-contained interactive HTML report")


def parse_discovery_args(argv=None):
    """Parser for the VCF-free discovery pipeline (kmer-discovery)."""
    parser = argparse.ArgumentParser(
        prog="kmer-discovery",
        description="VCF-free de novo k-mer discovery pipeline")
    _add_shared_args(parser)
    parser.add_argument(
        "--out-prefix", required=True,
        help="Output prefix for discovery mode files "
             "([prefix].bed, [prefix].informative.bam, "
             "[prefix].sv.bedpe, [prefix].kmer_coverage.bedgraph, "
             "[prefix].read_coverage.bed, [prefix].metrics.json, "
             "[prefix].summary.txt)")
    _add_discovery_args(parser)
    return parser.parse_args(argv)


def parse_args(argv=None):
    """Legacy combined parser (reference cli.py:233–387)."""
    parser = argparse.ArgumentParser(
        prog="kmer-denovo",
        description="De novo variant curation using k-mer analysis")
    _add_shared_args(parser)
    parser.add_argument(
        "--vcf", default=None,
        help="Input VCF with candidate variants. When omitted, runs "
             "VCF-free discovery mode (requires --out-prefix)")
    parser.add_argument("--output", "-o", default=None,
                        help="Output annotated VCF")
    parser.add_argument(
        "--out-prefix", default=None,
        help="Output prefix for discovery mode files")
    parser.add_argument("--metrics", default=None,
                        help="Output summary metrics JSON file")
    parser.add_argument(
        "--summary", default=None,
        help="Output human-readable summary of variant stats and "
             "likely DNMs")
    parser.add_argument(
        "--informative-reads", default=None,
        help="Output BAM with reads carrying informative k-mers")
    parser.add_argument(
        "--min-mapq", type=int, default=20,
        help="Minimum mapping quality for child reads in VCF mode "
             "(default: 20)")
    parser.add_argument(
        "--proband-id", default=None,
        help="Sample ID of the proband in the VCF")
    _add_discovery_args(parser)
    parser.add_argument(
        "--kraken2-db", default=None,
        help="Path to a Kraken2 database for non-human content "
             "classification (VCF mode)")
    parser.add_argument(
        "--kraken2-confidence", type=float, default=0.0,
        help="Kraken2 confidence threshold (default: 0.0)")
    parser.add_argument(
        "--kraken2-memory-mapping", action="store_true", default=False,
        help="Enable Kraken2 --memory-mapping")
    parser.add_argument("--kraken2-read-detail", default=None,
                        help="Per-read Kraken2 detail BED output path")
    parser.add_argument("--kraken2-span-bed", default=None,
                        help="Species-annotated span BED output path")
    parser.add_argument(
        "--no-expanded-bed", action="store_true", default=False,
        help="Disable the expanded span BED output")
    return parser.parse_args(argv)


def _join_multihost(device):
    """Join a multi-process run when configured; return the device this
    process runs on.

    Set ``KDF_COORDINATOR`` (host:port), ``KDF_NUM_PROCESSES`` and
    ``KDF_PROCESS_ID`` on every process to run ``kmer-denovo-torch`` /
    ``kmer-discovery-torch`` across N processes (reference
    cli.py:237–260): inputs stream in per-process stripes, partial
    results merge at module boundaries, and process 0 writes the
    outputs.  A CUDA process joins with NCCL on ``cuda:{rank % cards}``,
    a CPU one with gloo (:func:`~.parallel.multihost.initialize`).
    Without the variables this is a no-op and *device* stands.
    """
    device = torch.device(device)
    from kmer_denovo_filter_tpu_torch.parallel import multihost
    if not multihost.initialize(device=device):
        return device
    return multihost.device()


def vcf_main(argv=None, device="cuda"):
    """Entry point for ``kmer-denovo-torch`` (VCF mode on CUDA)."""
    device = _join_multihost(device)
    from kmer_denovo_filter_tpu_torch.vcf.pipeline import run_pipeline
    run_pipeline(parse_vcf_args(argv), device)


def discovery_main(argv=None, device="cuda"):
    """Entry point for ``kmer-discovery-torch`` (discovery on CUDA)."""
    device = _join_multihost(device)
    from kmer_denovo_filter_tpu_torch.discovery.pipeline import (
        run_discovery_pipeline,
    )
    run_discovery_pipeline(parse_discovery_args(argv), device)


# Copied from kmer_denovo_filter_tpu/cli.py:279–315 (parse_report_args,
# report_main), the report module renamed to the port's.

def parse_report_args(argv=None):
    """Parser for the standalone report generator (kmer-report)."""
    parser = argparse.ArgumentParser(
        prog="kmer-report",
        description=(
            "Generate an interactive HTML report from kmer-denovo / "
            "kmer-discovery output files without re-running the "
            "pipelines."))
    parser.add_argument("--output", "-o", required=True,
                        help="Output path for the HTML report.")
    parser.add_argument("--vcf-metrics", default=None,
                        help="VCF-mode metrics.json from kmer-denovo.")
    parser.add_argument("--vcf-summary", default=None,
                        help="VCF-mode summary.txt from kmer-denovo.")
    parser.add_argument(
        "--vcf", default=None,
        help="Annotated VCF from kmer-denovo (used for Kraken2 "
             "annotations if present).")
    parser.add_argument("--discovery-metrics", default=None,
                        help="Discovery metrics.json from kmer-discovery.")
    parser.add_argument("--discovery-summary", default=None,
                        help="Discovery summary.txt from kmer-discovery.")
    return parser.parse_args(argv)


def report_main(argv=None):
    """Entry point for ``kmer-report``."""
    from kmer_denovo_filter_tpu_torch.report import generate_report
    args = parse_report_args(argv)
    result = generate_report(
        output_path=args.output,
        vcf_metrics_path=args.vcf_metrics,
        vcf_summary_path=args.vcf_summary,
        vcf_path=args.vcf,
        discovery_metrics_path=args.discovery_metrics,
        discovery_summary_path=args.discovery_summary)
    print(f"Report written to: {result}")


def main(argv=None, device="cuda"):
    """Legacy combined entry point dispatching by mode (reference
    cli.py:318–337, on CUDA)."""
    device = _join_multihost(device)
    args = parse_args(argv)
    if args.vcf is not None:
        if args.output is None:
            print("error: --output is required when --vcf is provided",
                  file=sys.stderr)
            sys.exit(2)
        from kmer_denovo_filter_tpu_torch.vcf.pipeline import run_pipeline
        run_pipeline(args, device)
    else:
        if args.out_prefix is None:
            print("error: either --vcf (with --output) or --out-prefix "
                  "(for discovery mode) must be provided", file=sys.stderr)
            sys.exit(2)
        from kmer_denovo_filter_tpu_torch.discovery.pipeline import (
            run_discovery_pipeline,
        )
        run_discovery_pipeline(args, device)


if __name__ == "__main__":
    main()
