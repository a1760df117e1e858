"""Device k-mer engine, slice 1: the filtered counter of the parent scan.

Counterparts of :mod:`kmer_denovo_filter_tpu.engine`:

* :class:`KmerIndex` (:101) — the sorted child k-mer table, held on the
  device as one int64 key per row (:mod:`.ops.keys`);
* :class:`FilteredCounter` (:473) — ``jellyfish count -C --if``: a
  per-table-row tally of streamed read batches, on the small-table
  branch of the reference (:913–954, :983–1031);
* :func:`make_filtered_counter` (:1370), single device only.

The device is explicit: it is chosen at the entry point and passed to
:class:`KmerIndex`; the counter and its kernels run where the table
lives.  Keys of W > 2 words (k > 31) are not ported yet.

The reference's ``pad_read_batch`` (engine.py:70) has no counterpart:
it padded every batch to bound XLA's distinct compiled shapes, and the
CUDA kernels take any (B, L) without a recompile.
"""

import numpy as np
import torch

from kmer_denovo_filter_tpu.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical
from kmer_denovo_filter_tpu_torch.ops.probe import probe_tally


def resolve_device(device):
    """*device* as a ``torch.device``; raises for CUDA on a host
    without it (there is no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() "
            "is False")
    return device


class KmerIndex:
    """Sorted canonical k-mer table on *device*, with optional counts."""

    def __init__(self, keys_np, k, counts_np=None, *, device):
        """*keys_np*: (M, W) uint32 sorted unique canonical keys."""
        keys64.check_k(k)
        self.k = k
        self.w = enc.words_per_kmer(k)
        self.n = keys_np.shape[0]
        self.keys_np = keys_np
        self.counts_np = counts_np
        self.device = resolve_device(device)
        self.table = keys64.words_to_keys64(keys_np, k).to(self.device)

    @classmethod
    def from_strings(cls, kmers, k, *, device):
        """Build from canonical k-mer strings (order-independent)."""
        keys = enc.kmers_to_keys(list(kmers), k)
        uniq, _ = enc.unique_with_counts(keys)
        return cls(uniq, k, device=device)

    @classmethod
    def from_keys_counts(cls, keys_np, counts_np, k, *, device):
        return cls(keys_np, k, counts_np, device=device)

    def to_strings(self):
        return enc.keys_to_kmers(self.keys_np, self.k)


class FilteredCounter:
    """Count stream k-mers restricted to a fixed index (``--if`` analog)."""

    def __init__(self, index):
        self.index = index
        self.acc = torch.zeros(index.n, dtype=torch.int64,
                               device=index.device)

    def feed(self, codes, lengths):
        """Tally one (B, L) uint8 code batch with (B,) lengths.

        Host → device copy, K1 (window keys), then K2 adds the hits
        into the int64 accumulator IN PLACE — unlike the JAX counter,
        which rebinds a new accumulator array each step.  The batch goes
        over unpadded; one narrower than k holds no window.
        """
        if codes.shape[0] == 0 or codes.shape[1] < self.index.k:
            return
        device = self.index.device
        codes_t = torch.from_numpy(
            np.ascontiguousarray(codes, dtype=np.uint8)).to(device)
        lens_t = torch.from_numpy(
            np.ascontiguousarray(lengths, dtype=np.int32)).to(device)
        win = extract_canonical(codes_t, lens_t, self.index.k)
        probe_tally(win.reshape(-1), self.index.table, self.acc)

    def result(self):
        """int64 counts aligned with the index's sorted keys."""
        return self.acc.to("cpu", copy=True).numpy()


def make_filtered_counter(index):
    """Single-device :class:`FilteredCounter` (multi-device sharding is
    ROADMAP queue 1 item 9)."""
    return FilteredCounter(index)
