"""Re-export shim (counterpart of ``kmer_denovo_filter_tpu.pipeline``)."""

from kmer_denovo_filter_tpu_torch.discovery.pipeline import (  # noqa: F401
    run_discovery_pipeline,
)
from kmer_denovo_filter_tpu_torch.vcf.pipeline import (  # noqa: F401
    _collect_child_kmers,
    _parse_vcf_variants,
    _write_informative_reads,
    _write_summary,
    run_pipeline,
)
