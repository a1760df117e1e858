"""The prefix directory of a sorted table: kernels K2 and K4
(:mod:`.probe`, :mod:`.member`) search a narrow (M,) table through it on
the card, K7 and K8 a wide (M, Q) one.

The table's live rows (those before its trailing sentinel rows) fall
into ``2**bits`` buckets by their top bits: bucket ``p`` holds the rows
whose ``key >> shift == p``, with ``shift = max(0, bitlen(last live key)
- bits)`` so the rule needs no k.  The key of a wide row is its limb 0
(bases 0..30, right-aligned below 2**62; :mod:`.keys`): rows sorted
lexicographically have a non-decreasing limb 0, so it buckets them as a
narrow key is bucketed, and rows that share their first 31 bases share a
bucket.  ``offsets[p]`` is the first live row whose ``key >> shift >=
p`` and ``offsets[2**bits] = live``, so a query searches only the rows
``[offsets[p], offsets[p + 1])`` (``csrc/sorted_table.cuh``,
``csrc/sorted_rows.cuh``).  Sizing (:func:`directory_bits`, measured on
an H100, PERF.md): ``bits = ceil(log2(live))``, about one row a bucket
and 2-4 B a row, while that takes at most :data:`FINE_BITS` (a 16 MB
directory, a third of the L2); past it ``ceil(log2(live)) - 2``, about
2-4 rows (one 32-byte sector) a bucket and 1 B a row.  The staged form
of K2 and K4 copies this directory into shared memory.

K2, K3 and K4 launch in a plan that ``kdf::dir_probe_launch``
(``csrc/sorted_table.cuh``) picks from the table and the card: the
staged form of K2 and K4 in 512-thread blocks, two an SM, where the
table fits, else the global form in 256-thread blocks, four an SM.  A
:class:`Launch` override sets the form, the threads a block and a cap
on the blocks an SM (the experiments ``x_fused variants`` and ``steps``
sweep them); the engine never passes one.  :func:`launch_plan` reads
the plan without launching.

A directory belongs to a table: the engine builds it once per table
(``KmerIndex``), never per batch.  :func:`build_directory` launches
``kdf_build_directory`` (``csrc/directory.cu``) for a CUDA table and
runs :func:`plain_directory` for a CPU one.  The reference's XLA
counterpart is ``kmer_denovo_filter_tpu/ops/device.py``
``build_bucket_offsets`` (:572), host-built for ``lookup_bucketed``.
"""

import ctypes
from typing import NamedTuple

import torch

from kmer_denovo_filter_tpu_torch import tracing
from kmer_denovo_filter_tpu_torch.ops import _cuda
from kmer_denovo_filter_tpu_torch.ops.keys import SENTINEL


# the finest directory kept for a large table: 2**22 int32 entries, 16 MB
FINE_BITS = 22


class Directory(NamedTuple):
    """A table's prefix directory: (2**bits + 1,) int32 *offsets* on the
    table's device, its *bits* and *shift*, the table's *live* rows, and
    the *table* it was built from (a probe refuses it for any other)."""
    offsets: torch.Tensor
    bits: int
    shift: int
    live: int
    table: torch.Tensor


def directory_bits(live):
    """bits of the directory of a table with *live* rows: ceil(log2(live))
    up to :data:`FINE_BITS`, past it no fewer than ceil(log2(live)) - 2."""
    c = (max(live, 1) - 1).bit_length()
    return max(c - 2, min(c, FINE_BITS))


def directory_bytes(n_rows):
    """Device bytes of the directory of an *n_rows*-row table."""
    return 4 * ((1 << directory_bits(n_rows)) + 1)


def _keys(table):
    """The bucketed key of each row: the (M,) table, or limb 0 of an
    (M, Q) one."""
    return table if table.dim() == 1 else table[:, 0]


def plain_directory(table, live, bits, shift):
    """The plain version of ``kdf_build_directory``: (2**bits + 1,)
    int32, the first of the *live* rows of sorted *table* ((M,) keys or
    (M, Q) limb rows, by limb 0) whose key >> *shift* is at least p, for
    each p."""
    prefixes = _keys(table)[:live] >> shift
    p = torch.arange((1 << bits) + 1, dtype=torch.int64,
                     device=table.device)
    return torch.searchsorted(prefixes.contiguous(), p).to(torch.int32)


def build_directory(table, live=None, max_key=None):
    """The :class:`Directory` of sorted (M,) int64 *table*, or of an
    (M, Q) int64 table of limb rows by limb 0 (trailing sentinel rows
    allowed).  *live* and *max_key* (the last live key, or limb 0 of the
    last live row) are read from the table when not given, which on the
    card is a host sync; a caller that knows them from the host passes
    them.  A CUDA table launches ``kdf_build_directory``; a CPU one runs
    the plain version."""
    if table.dim() not in (1, 2) or table.dtype != torch.int64:
        raise ValueError(f"expected an (M,) or (M, Q) int64 table, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if table.shape[0] >= 1 << 31:
        raise ValueError(f"table of {table.shape[0]} keys exceeds the "
                         "kernels' int32 row index")
    if live is None:
        live = int((_keys(table) != SENTINEL).sum())
        max_key = int(_keys(table)[live - 1]) if live else 0
    bits = directory_bits(live)
    shift = max(0, int(max_key).bit_length() - bits) if live else 0
    if table.device.type == "cpu":
        return Directory(plain_directory(table, live, bits, shift), bits,
                         shift, live, table)
    if not table.is_contiguous():
        raise ValueError("the table must be contiguous")
    offsets = torch.empty((1 << bits) + 1, dtype=torch.int32,
                          device=table.device)
    with torch.cuda.device(table.device):
        err = _cuda.lib().kdf_build_directory(
            table.data_ptr(), 1 if table.dim() == 1 else table.shape[1],
            live, bits, shift, offsets.data_ptr(), _cuda.stream_of(table))
    _cuda.check(err, "build_directory")
    tracing.count("launches.build_directory")
    return Directory(offsets, bits, shift, live, table)


def directory_for(table, directory):
    """*directory* checked against *table*, or a new one built from it
    (on the card counted in ``launches.build_directory``) when *directory*
    is None.  A directory built from another table is refused, even one
    of the same size."""
    if directory is None:
        return build_directory(table)
    offsets, own = directory.offsets, directory.table
    if (own.data_ptr() != table.data_ptr() or own.shape != table.shape
            or own.device != table.device
            or offsets.device != table.device or offsets.dtype != torch.int32
            or offsets.shape != ((1 << directory.bits) + 1,)
            or not offsets.is_contiguous()
            or not 0 <= directory.live <= table.shape[0]):
        raise ValueError("the directory does not belong to this table")
    return directory


# the forms of a directory probe, as the C entry points number them
FORMS = {"auto": 0, "staged": 1, "global": 2}
THREADS = (128, 256, 512)  # the block sizes a launch override may set
MAX_BLOCKS_PER_SM = 32


class Launch(NamedTuple):
    """A launch override of K2, K3 or K4: *form* ``"auto"`` (the plan),
    ``"staged"`` (K2 and K4 only, where the table fits) or ``"global"``;
    *threads* a block, one of :data:`THREADS`; *blocks_per_sm*, a cap
    of 1..32 on the grid's blocks an SM.  0 keeps the plan's value."""
    form: str = "auto"
    threads: int = 0
    blocks_per_sm: int = 0


class Plan(NamedTuple):
    """A directory probe's launch: *staged* form or not, *blocks*,
    *threads* a block, dynamic *smem* bytes a block (0 in the global
    form) and the staged form's shared-memory *budget* a block."""
    staged: bool
    blocks: int
    threads: int
    smem: int
    budget: int


def launch_args(launch):
    """*launch* (a :class:`Launch` or None) as the C entry points'
    (form, threads, blocks_per_sm) ints, (0, 0, 0) for None; raises
    ``ValueError`` for a value the kernels do not take."""
    if launch is None:
        return 0, 0, 0
    form, threads, per_sm = launch
    if (form not in FORMS or threads not in (0,) + THREADS
            or not 0 <= per_sm <= MAX_BLOCKS_PER_SM):
        raise ValueError(f"launch override {launch!r}: form in "
                         f"{tuple(FORMS)}, threads 0 or in {THREADS}, "
                         f"blocks_per_sm in 0..{MAX_BLOCKS_PER_SM}")
    return FORMS[form], threads, per_sm


def launch_plan(n, live, bits, counts, launch=None):
    """The :class:`Plan` of K2 (*counts* True: 8 more bytes a staged
    row) or K4 over *n* keys of a table with *live* rows and a directory
    of *bits*, on the current CUDA device, under *launch*.  Raises
    ``ValueError`` when *launch* asks for the staged form of a table
    that does not fit."""
    args = launch_args(launch)
    if args[0] == FORMS["staged"] and not launch_plan(
            n, live, bits, counts, launch._replace(form="auto")).staged:
        raise ValueError(f"the staged form holds no table of {live} live "
                         "rows on this card (over the staged edge)")
    out = (ctypes.c_longlong * 5)()
    _cuda.check(_cuda.lib().kdf_dir_probe_plan(n, live, bits, int(counts),
                                               *args, out),
                "dir_probe_plan")
    return Plan(bool(out[0]), *out[1:])
