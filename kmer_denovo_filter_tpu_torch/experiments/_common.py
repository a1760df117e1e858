"""What the experiment scripts share: the synthetic reads and stacked
groups of them, the WGS-scale filter table, tables drawn from a batch,
a timer, parity lines and the command line.

The reads, the groups and the table follow the JAX scripts' recipes
(``scripts/x_fused.py:synth_reads`` :41, ``run_super`` :763-767 and
``_wgs_table`` :214), with the port's int64 keys in place of mixed
uint32 planes.  The WGS table is built once per (device, M) in a
process (:func:`wgs_index`): ``chip_smoke.py`` phase 7 runs every
command in one process.
"""

import argparse
import time

import numpy as np
import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch.ops import keys as keys64
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
GENOME_SEED = 0  # the genome is the first draw of the run's generator
TABLE_SEED = 1   # the WGS table's random keys: a generator of their own
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak
# H100 SXM float32 peak outside the tensor cores: no integer rate is
# published, and an int64 compare is no cheaper, so the count over it is
# a floor
OPS_PER_S = 67e12


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
    rng = np.random.default_rng(GENOME_SEED)
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


def window_keys(codes, lengths):
    """The flat (N,) int64 k = 31 window keys of a batch (K1)."""
    return extract_canonical(codes, lengths, K).reshape(-1)


def random_batch(rng, n_reads, device):
    """(codes, lengths) of *n_reads* uniformly random READ_LEN reads on
    *device*: no repeats, unlike a 40x batch."""
    codes = rng.integers(0, 4, (n_reads, READ_LEN), dtype=np.uint8)
    return (torch.from_numpy(codes).to(device),
            torch.full((n_reads,), READ_LEN, dtype=torch.int32,
                       device=device))


def read_group(rng, genome, nb, n_reads):
    """A stacked group of *nb* synthetic batches, as host arrays: (nb,
    n_reads, READ_LEN) uint8 codes and (nb, n_reads) int32 lengths (the
    recipe of ``scripts/x_fused.py:run_super`` :763-767)."""
    codes = np.stack([synth_reads(rng, genome, n_reads) for _ in range(nb)])
    return codes, np.full((nb, n_reads), READ_LEN, np.int32)


_WGS = {}  # (device, M) -> the WGS table's KmerIndex, built once a process


def wgs_index(m, device):
    """The WGS-scale filter table as a :class:`~engine.KmerIndex` on
    *device* (``.table``, sorted (M',) int64; ``.directory`` on a card):
    the canonical k = 31 keys of the run's genome cut into 256-base
    rows, plus *m* random keys below 4**31 (the recipe of
    ``scripts/x_fused.py:_wgs_table`` :214).  The genome is
    :func:`setup`'s, drawn again from its seed, and the random keys
    come from a generator of their own, so the table is the same
    whichever command asks first; it is built once per (device, *m*)
    in a process and must not be written to."""
    device = torch.device(device)
    key = (str(device), m)
    if key not in _WGS:
        genome = np.random.default_rng(GENOME_SEED).integers(
            0, 4, GENOME_BASES, dtype=np.uint8)
        rows = len(genome) // 256
        gcodes = torch.from_numpy(genome[:rows * 256].reshape(rows, 256))
        glens = torch.full((rows,), 256, dtype=torch.int32)
        gkeys = extract_canonical(gcodes.to(device), glens.to(device),
                                  K).reshape(-1)
        rand = np.random.default_rng(TABLE_SEED).integers(
            0, 4 ** K, m, dtype=np.int64)
        host = torch.unique(torch.cat([
            gkeys[gkeys != SENTINEL], torch.from_numpy(rand).to(device)
        ])).cpu()
        _WGS[key] = eng.KmerIndex(keys64.keys64_to_words(host, K), K,
                                  device=device, key_tensor=host)
    return _WGS[key]


def batch_table(rng, flat, m, device):
    """Sorted unique (m,) int64 table on *device*: half of it distinct
    live keys of the window stream *flat* (all of them when fewer), the
    rest random keys below 4**31, drawn from *rng*."""
    live = torch.unique(flat[flat != SENTINEL]).cpu().numpy()
    chosen = live[rng.permutation(live.size)[:max(1, m // 2)]]
    rand = np.setdiff1d(rng.integers(0, 4 ** K, 2 * m + 16, dtype=np.int64),
                        chosen)
    keys = np.sort(np.concatenate(
        [chosen, rng.permutation(rand)[:m - chosen.size]]))
    if keys.size != m:
        raise RuntimeError(f"drew a table of {keys.size} keys, wanted {m}")
    return torch.from_numpy(keys).to(device)


def pair_order(keys, payload):
    """Each row's (key, payload) pairs in lexicographic order: a form in
    which two sorts of one segment are equal exactly when their pair
    multisets are."""
    by_pay = torch.sort(payload, dim=1, stable=True).indices
    keys, payload = keys.gather(1, by_pay), payload.gather(1, by_pay)
    by_key = torch.sort(keys, dim=1, stable=True).indices
    return keys.gather(1, by_key), payload.gather(1, by_key)


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
