"""Inputs made from the seed: a parent's reads and a child's filter table.

Frozen plain PyTorch, made on the run's device with ``torch.Generator``
in a few large calls.  The read recipe is ``bench.py``'s ``synth_reads``
(reads sampled position-locally over a synthetic genome, each base
substituted with the mix's error rate), widened to a trio:

* a reference slice of ``pool_reads * read_length / coverage`` random
  bases, so the pool covers it at the mix's coverage;
* the parent's two haplotypes: the reference with heterozygous SNVs,
  one every ``het_snv_every_bp`` on average, each on one haplotype;
* the child: the parent's first haplotype (transmitted whole) and the
  other parent's transmitted haplotype (the reference with SNVs at half
  that density);
* the filter table: every canonical k-mer of the child's haplotypes that
  covers one of the child's variant sites (its non-reference keys), then
  random canonical keys up to the configuration's ``filter_table_keys``,
  sorted and unique;
* the parent's reads: start and haplotype drawn at random, errors
  applied, in coordinate order (a sorted BAM) or the same reads shuffled
  (a name-sorted or collated BAM), each batch then a thin stride over
  the whole slice, as a whole-genome batch is.

Sub-streams (genome, sites, reads, table) each take a generator seeded
from the run's seed and their name, so each is the same for a seed
whatever the sizes of the others.
"""

import hashlib

import torch

from portbench import kmerwords as kw

# random table keys are drawn a chunk at a time: (chunk, k) int64 codes
_KEY_CHUNK = 1 << 22


def generator(seed, name, device):
    """A ``torch.Generator`` on *device* for the stream *name* of *seed*."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return torch.Generator(device=device).manual_seed(
        int.from_bytes(digest[:8], "little") >> 1)


def slice_bases(cfg, traffic):
    """Bases of the reference slice the pool covers at the coverage."""
    return (cfg["pool_reads"] * traffic["read_length"]
            // traffic["coverage"])


def _substitute(codes, positions, gen):
    """*codes* with each of *positions* changed to another base."""
    out = codes.clone()
    shift = torch.randint(1, 4, positions.shape, generator=gen,
                          device=codes.device, dtype=torch.uint8)
    out[positions] = (codes[positions] + shift) % 4
    return out


def make_trio(cfg, traffic, seed, device):
    """(parent haplotypes (2, G) uint8, child haplotypes (2, G) uint8,
    the child's variant positions on each haplotype)."""
    g = slice_bases(cfg, traffic)
    every = traffic["het_snv_every_bp"]
    gen = generator(seed, "genome", device)
    ref = torch.randint(0, 4, (g,), generator=gen, device=device,
                        dtype=torch.uint8)
    gen = generator(seed, "sites", device)
    sites = torch.randperm(g, generator=gen, device=device)[:g // every]
    on_first = torch.randint(0, 2, sites.shape, generator=gen,
                             device=device).bool()
    parent = torch.stack([_substitute(ref, sites[on_first], gen),
                          _substitute(ref, sites[~on_first], gen)])
    other = torch.randperm(g, generator=gen, device=device)[:g // (2 * every)]
    child = torch.stack([parent[0], _substitute(ref, other, gen)])
    return parent, child, [sites[on_first], other]


def covering_keys(hap, positions, k):
    """Canonical packed keys of every k-window of *hap* that covers one of
    *positions*: (N, C) int64 columns, with repeats."""
    g = hap.shape[0]
    offs = torch.arange(k, device=hap.device)
    starts = (positions.unsqueeze(1) - offs.unsqueeze(0)).flatten()
    starts = torch.unique(starts[(starts >= 0) & (starts <= g - k)])
    windows = hap[starts.unsqueeze(1) + offs.unsqueeze(0)]
    lengths = torch.full((windows.shape[0],), k, device=hap.device)
    keys, _ = kw.window_keys(windows, lengths, k)
    return keys[:, 0]


def _random_keys(n, k, gen, device):
    """*n* random canonical packed keys: (n, C) int64 columns."""
    out = []
    for lo in range(0, n, _KEY_CHUNK):
        rows = min(_KEY_CHUNK, n - lo)
        codes = torch.randint(0, 4, (rows, k), generator=gen, device=device,
                              dtype=torch.uint8)
        lengths = torch.full((rows,), k, device=device)
        out.append(kw.window_keys(codes, lengths, k)[0][:, 0])
    return torch.cat(out) if out else torch.zeros(
        0, kw.columns_per_kmer(k), dtype=torch.int64, device=device)


def make_table(child, child_sites, k, m, seed, device):
    """The child's non-reference keys topped up with random canonical keys
    to *m*: (m, C) sorted unique int64 columns, and how many are the
    child's."""
    own = kw.unique_counts(torch.cat([covering_keys(child[h], child_sites[h],
                                                    k) for h in range(2)]))[0]
    if own.shape[0] > m:
        raise ValueError(f"the child has {own.shape[0]} non-reference keys, "
                         f"more than the table's {m}")
    gen = generator(seed, "table", device)
    table = own
    while table.shape[0] < m:  # random draws rarely repeat: one round
        table = kw.unique_counts(torch.cat(
            [table, _random_keys(m - table.shape[0], k, gen, device)]))[0]
    return table, own.shape[0]


def make_reads(parent, cfg, traffic, seed, device):
    """The pool's reads: (pool_reads, read_length) uint8 codes on *device*,
    in the mix's order."""
    n, length = cfg["pool_reads"], traffic["read_length"]
    g = parent.shape[1]
    gen = generator(seed, "reads", device)
    starts = torch.sort(torch.randint(0, g - length + 1, (n,), generator=gen,
                                      device=device)).values
    hap = torch.randint(0, 2, (n,), generator=gen, device=device)
    flat = parent.flatten()
    offs = torch.arange(length, device=device)
    codes = torch.empty(n, length, dtype=torch.uint8, device=device)
    step = traffic["batch_reads"]
    for lo in range(0, n, step):  # a batch at a time: the gather is int64
        hi = min(lo + step, n)
        idx = (hap[lo:hi] * g + starts[lo:hi]).unsqueeze(1) + offs
        reads = flat[idx]
        err = torch.rand(reads.shape, generator=gen,
                         device=device) < traffic["error_rate"]
        shift = torch.randint(1, 4, reads.shape, generator=gen,
                              device=device, dtype=torch.uint8)
        codes[lo:hi] = torch.where(err, (reads + shift) % 4, reads)
    if traffic["order"] == "shuffled":
        # a name-sorted BAM's batch draws its reads from all over the
        # genome, so hardly two of them overlap: batch j takes every
        # (n / step)-th read in coordinate order from the j-th, in random
        # order, and covers the slice once, thinly, without repeats
        gen = generator(seed, "order", device)
        strided = torch.arange(n, device=device).view(step, n // step).t()
        order = torch.argsort(torch.rand(strided.shape, generator=gen,
                                         device=device), dim=1)
        codes = codes[strided.gather(1, order).flatten()]
    elif traffic["order"] != "coordinate":
        raise ValueError(f"unknown read order {traffic['order']!r}")
    return codes
