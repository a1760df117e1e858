"""Multi-device and multi-host scaling: hash-owner sharded k-mer tables
over a mesh of torch devices (:mod:`.sharded`) and N-process runs over
``torch.distributed`` (:mod:`.multihost`).  The JAX package's TPU
lane-tile counters (``ShardedTileCounter``, ``ShardedTileScanner``) are
not ported."""

from kmer_denovo_filter_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedFilteredCounter,
    ShardedKmerIndex,
    ShardedStreamCounter,
    make_mesh,
    sharded_count,
    sharded_scan_reads_for_hits,
)
from kmer_denovo_filter_tpu_torch.parallel import multihost  # noqa: F401
