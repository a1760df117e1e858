"""What the experiment scripts share: the synthetic reads, the WGS-scale
filter table, a timer, parity lines and the command line.

The reads and the table follow the JAX scripts' recipes
(``scripts/x_fused.py:synth_reads`` :41 and ``_wgs_table`` :214), with
the port's int64 keys in place of mixed uint32 planes.
"""

import argparse
import time

import numpy as np
import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch.ops.extract import extract_canonical
from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL
from kmer_denovo_filter_tpu_torch.ops.timing import device_ms

K = 31
READ_LEN = 152
BATCH_READS = 32768
COVERAGE = 40
ERROR_RATE = 0.003
GENOME_BASES = 4 << 20
WGS_TABLE_M = 1 << 24
V5_BATCHES = 4  # batches each parent-filter form feeds in ``v5``
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
OPS_PER_S = 67e12          # H100 SXM float32 peak outside the tensor cores


def parse_args(prog, commands, argv):
    """The scripts' command line, ``<command> [--device cuda|cpu]
    [--reps N]``, plus the run's sizes as ``reads`` (a batch) and
    ``table_m`` (random table keys), read from :data:`BATCH_READS` and
    :data:`WGS_TABLE_M` when called."""
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("command", choices=commands)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=8,
                    help="timed repetitions of each step")
    args = ap.parse_args(argv)
    args.reads, args.table_m = BATCH_READS, WGS_TABLE_M
    return args


def setup(args):
    """(device, rng, genome) for a run; prints the device line."""
    device = eng.resolve_device(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "host CPU")
    print(f"device: {device} ({name}), torch {torch.__version__}",
          flush=True)
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, GENOME_BASES, dtype=np.uint8)
    return device, rng, genome


def synth_reads(rng, genome, n_reads, read_len=READ_LEN):
    """(n_reads, read_len) uint8 codes: position-local reads at 40x
    coverage with 0.3 % substitution errors, like a sorted WGS BAM."""
    span = max(n_reads * read_len // COVERAGE, read_len * 4)
    start0 = rng.integers(0, len(genome) - span - read_len)
    starts = np.sort(rng.integers(start0, start0 + span, n_reads))
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    err = rng.random((n_reads, read_len)) < ERROR_RATE
    return np.where(err, (reads + rng.integers(
        1, 4, (n_reads, read_len))) % 4, reads).astype(np.uint8)


def read_batch(rng, genome, n_reads, device):
    """One synthetic batch as (codes, lengths) tensors on *device*."""
    codes = torch.from_numpy(synth_reads(rng, genome, n_reads)).to(device)
    lengths = torch.full((n_reads,), READ_LEN, dtype=torch.int32,
                         device=device)
    return codes, lengths


def wgs_table(rng, genome, m, device):
    """Sorted (M,) int64 filter table: the canonical k = 31 keys of the
    genome cut into 256-base rows, plus *m* random keys below 4**31 (the
    recipe of ``scripts/x_fused.py:_wgs_table``)."""
    rows = len(genome) // 256
    gcodes = torch.from_numpy(genome[:rows * 256].reshape(rows, 256))
    glens = torch.full((rows,), 256, dtype=torch.int32)
    gkeys = extract_canonical(gcodes.to(device), glens.to(device),
                              K).reshape(-1)
    rand = torch.from_numpy(rng.integers(0, 4 ** K, m, dtype=np.int64))
    return torch.unique(torch.cat([gkeys[gkeys != SENTINEL],
                                   rand.to(device)]))


def timeit(label, fn, device, reps):
    """Mean milliseconds of *fn* over *reps* calls after a warm-up:
    device time by CUDA events on the card (``ops.timing.device_ms``),
    the host clock on the CPU.  Prints a labelled line and returns the
    time."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            ms = device_ms(fn, reps)
    else:
        fn()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t) * 1e3 / reps
    print(f"{label:44s} {ms:10.4f} ms", flush=True)
    return ms


def parity(label, ok):
    """Print a parity line and fail unless *ok*."""
    print(f"  {label} parity: {ok}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: parity failed")


def bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the least card time for work that
    moves *n_bytes* and does *n_ops* operations, at the H100's peaks."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / OPS_PER_S * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))
