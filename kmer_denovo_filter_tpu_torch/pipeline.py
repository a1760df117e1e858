"""Re-export shim (counterpart of ``kmer_denovo_filter_tpu.pipeline``):
every name the reference's shim exports (its pipeline.py:8–46)."""

from kmer_denovo_filter_tpu_torch.vcf.pipeline import (  # noqa: F401
    _collect_child_kmers,
    _parse_vcf_variants,
    _write_informative_reads,
    _write_summary,
    run_pipeline,
)
from kmer_denovo_filter_tpu_torch.discovery.pipeline import (  # noqa: F401
    SULOVARI_DNM_REGIONS,
    _anchor_and_cluster,
    _annotate_and_link_from_metadata,
    _classify_regions,
    _compare_candidates_to_regions,
    _evaluate_dnm_regions,
    _extract_softclips,
    _infer_sv_type,
    _parse_candidate_summary,
    _write_bed,
    _write_bedgraph,
    _write_bedpe,
    _write_discovery_summary,
    _write_empty_discovery_outputs,
    _write_informative_reads_discovery,
    _write_read_coverage_bed,
    run_discovery_pipeline,
)
from kmer_denovo_filter_tpu_torch.kmer import (  # noqa: F401
    canonicalize,
    extract_variant_spanning_kmers,
    read_supports_alt,
    reverse_complement,
)
from kmer_denovo_filter_tpu_torch.utils import (  # noqa: F401
    format_elapsed,
    load_kmers_from_fasta,
    resolve_tmp_dir,
    validate_inputs,
    write_kmer_fasta,
)
