"""Entry points of the port: a one-step check and a
multi-device dry run; the counterpart of the repository's
``__graft_entry__.py``, which stays the JAX package's.

    python -m kmer_denovo_filter_tpu_torch.entry

runs both on the card: :func:`entry`'s step on its example arguments,
then :func:`dryrun_multichip` over every local card (at most 8).
"""

import numpy as np
import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch import kmer as kmer_mod
from kmer_denovo_filter_tpu_torch.ops import encode as enc
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
from kmer_denovo_filter_tpu_torch.ops.directory import build_directory
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical
from kmer_denovo_filter_tpu_torch.ops.probe import probe_tally

# the step's shapes (``__graft_entry__.py:entry`` :19-22)
K = 31
BATCH, LENGTH = 256, 160
TABLE_M = 1 << 14
# the dry run's reads: 4 a device, 64 bases (``dryrun_multichip`` :68-69)
READS_PER_DEVICE, READ_BASES = 4, 64


def entry(device="cuda"):
    """``(fn, example_args)`` for one step of the engine's inner loop.

    ``fn(table, acc, codes, lengths)`` runs K1 (``extract_canonical``)
    over a (B, L) uint8 code batch with (B,) int32 lengths, then K2
    (``probe_tally``) of its window keys against the sorted (M,) int64
    *table* through the table's prefix directory (built once for each
    table the step is given), adding into the (M,) int64 *acc* in place.
    It returns ``(acc, n_valid_windows)``: the counterpart of
    ``__graft_entry__.py:entry`` :6, whose step returns a new int32
    accumulator.  It runs the plain versions when its tensors are on
    the CPU.

    *example_args* come from ``np.random.default_rng(0)`` in the order
    of ``__graft_entry__.py`` :32-40: a 256 x 160 batch, then a table of
    2**14 random uint32 word pairs (padding bits cleared) in the JAX
    word order, converted by :mod:`.ops.keys`, so row i of the table is
    row i of the JAX one.  On *device*, which is the card unless the
    caller asks for the CPU.
    """
    device = eng.resolve_device(device)
    held = {}  # the directory of the last CUDA table the step was given

    def step(table, acc, codes, lengths):
        keys = extract_canonical(codes, lengths, K).reshape(-1)
        directory = None
        if table.device.type == "cuda":
            directory = held.get("directory")
            if directory is None or directory.table is not table:
                directory = held["directory"] = build_directory(table)
        probe_tally(keys, table, acc, directory)
        return acc, (keys != keys64.SENTINEL).sum()

    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, (BATCH, LENGTH), dtype=np.uint8)
    lengths = np.full(BATCH, LENGTH, dtype=np.int32)
    words = rng.integers(0, 2 ** 32, (TABLE_M, 2), dtype=np.uint32)
    words[:, 1] &= 0xFFFFFFFC  # valid key padding bits
    words = words[enc.lexsort_keys(words)]
    table = keys64.words_to_keys64(words, K).to(device)
    acc = torch.zeros(TABLE_M, dtype=torch.int64, device=device)
    return step, (table, acc, torch.from_numpy(codes).to(device),
                  torch.from_numpy(lengths).to(device))


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices, mesh=None):
    """One pass of the sharded engine (:mod:`.parallel.sharded`) on an
    *n_devices* mesh, with the checks of ``__graft_entry__.py:
    dryrun_multichip`` :44-105: ``sharded_count``; a
    ``ShardedKmerIndex`` (``membership`` finds its own keys,
    ``tally_batch`` then ``tally_result`` counts each once); a
    ``ShardedFilteredCounter`` fed the reads; the sharded anchoring
    scan, whose table reads anchor.  The reference's tile counters
    (:106-122, the TPU lane-tile layout) are not ported.

    *mesh*: a list of *n_devices* ``torch.device`` (a device may
    repeat; the CPU tests pass ``[cpu] * n``), or None for
    ``parallel.make_mesh(n_devices)``, the first *n_devices* local
    cards, which raises on a host with none.  Raises
    ``AssertionError`` when a check fails."""
    from kmer_denovo_filter_tpu_torch.parallel import (
        ShardedFilteredCounter,
        ShardedKmerIndex,
        make_mesh,
        sharded_count,
        sharded_scan_reads_for_hits,
    )

    mesh = make_mesh(n_devices) if mesh is None else list(mesh)
    if len(mesh) != n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(mesh)}")
    k = K
    rng = np.random.default_rng(0)
    bases = np.array(list("ACGT"))
    reads = ["".join(bases[rng.integers(0, 4, READ_BASES)])
             for _ in range(READS_PER_DEVICE * n_devices)]
    codes = np.stack([
        enc.ASCII_TO_CODE[np.frombuffer(s.encode(), dtype=np.uint8)]
        for s in reads])
    lengths = np.full(len(reads), READ_BASES, dtype=np.int32)

    # distributed count: every window key routed to its owner shard
    keys, counts = sharded_count(codes, lengths, k, mesh)
    _check(keys.shape[0] > 0 and counts.sum() > 0, "sharded_count is empty")

    # sharded table + routed membership probe + owner-side tally
    table_kmers = sorted({c for s in reads[:2]
                          for c in kmer_mod.extract_read_kmers(s, k)[0]
                          .values()})
    keys = enc.kmers_to_keys(table_kmers, k)
    index = ShardedKmerIndex(keys, k, mesh)
    found = index.membership(enc.kmers_to_keys(table_kmers, k))
    _check(found.all(), "sharded membership must find its own table keys")
    index.tally_batch(enc.kmers_to_keys(table_kmers, k))
    _check(index.tally_result().sum() == len(table_kmers),
           "the sharded tally must count each table key once")

    # the parent filter on the mesh: extract, route, owner-side tally
    counter = ShardedFilteredCounter(keys, k, mesh)
    counter.feed(codes, lengths)
    _check(counter.result().sum() > 0, "the sharded filter counted nothing")

    # the anchoring scan on the mesh (discovery Module 3)
    hits = sharded_scan_reads_for_hits(index, codes, lengths)
    _check(hits.shape == (len(reads), READ_BASES - k + 1),
           f"scan mask of shape {hits.shape}")
    _check(hits[:2].any(), "table reads must anchor to their own k-mers")


def main():
    fn, args = entry()
    acc, n_valid = fn(*args)
    torch.cuda.synchronize()
    print(f"entry ok: acc {tuple(acc.shape)} {acc.dtype}, "
          f"{int(n_valid)} valid windows, {int(acc.sum())} hits", flush=True)
    n = min(8, torch.cuda.device_count())
    dryrun_multichip(n)
    print(f"dryrun_multichip ok on {n} card(s)", flush=True)


if __name__ == "__main__":
    main()
