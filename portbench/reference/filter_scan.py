"""Plain reference of the filter scan: the table's counts recounted.

``jellyfish count -C --if`` semantics, written apart from the port: every
valid k-window of every read fed (inside the read, no code above 3) is
counted once, under its canonical key, against the table row that holds
that key; a key the table lacks is not counted.  The table comes as the
host words both sides were handed, the reads as the pool and the number
of times the window fed each of its batches.  Plain PyTorch on the run's
device, a batch at a time, after the program's state is freed.
"""

import torch

from portbench import kmerwords as kw


class Table:
    """The filter table as sorted (M, C) columns on *device*, searchable."""

    def __init__(self, words_np, k, device):
        self.k = k
        words = torch.from_numpy(words_np.view("int32")).to(device)
        cols = kw.from_uint32_words(words, k)
        del words
        self.m = cols.shape[0]
        self.cols = [cols[:, c].contiguous() for c in range(cols.shape[1])]
        del cols
        # the longest run of rows that share column 0: the search walks
        # that far past its first candidate
        if self.m:
            run = torch.unique_consecutive(self.cols[0],
                                           return_counts=True)[1]
            self.run = int(run.max())
        else:
            self.run = 0

    def rows_of(self, keys):
        """Table row of each (N, C) key, -1 where the table lacks it."""
        rows = torch.full((keys.shape[0],), -1, dtype=torch.int64,
                          device=keys.device)
        if not self.m or not keys.shape[0]:
            return rows
        first = torch.searchsorted(self.cols[0], keys[:, 0].contiguous())
        for step in range(self.run):
            at = first + step
            inside = at < self.m
            at = torch.where(inside, at, torch.zeros_like(at))
            hit = inside & (rows < 0)
            for c, col in enumerate(self.cols):
                hit &= col[at] == keys[:, c]
            rows = torch.where(hit, at, rows)
        return rows


def batch_tally(table, codes, lengths, canonical=True):
    """(rows hit, their counts, distinct valid keys) of one batch."""
    keys, valid = kw.window_keys(codes, lengths, table.k, canonical)
    distinct, counts = kw.unique_counts(keys[valid])
    rows = table.rows_of(distinct)
    found = rows >= 0
    return rows[found], counts[found], distinct.shape[0]


def expected_counts(words_np, k, pool, feeds, device, canonical=True):
    """The counts the scan owes, and the work per pool batch.

    *pool*: [(codes (B, L) uint8, lengths (B,) int32) numpy]; *feeds*:
    how many times the window fed each.  Returns ((M,) int64 counts on
    *device*, [(distinct keys, table rows hit) per pool batch]).  With
    *canonical* False each window counts under its forward string alone
    (a broken guarantee: the control)."""
    table = Table(words_np, k, device)
    counts = torch.zeros(table.m, dtype=torch.int64, device=device)
    work = []
    for (codes, lengths), times in zip(pool, feeds):
        rows, n, distinct = batch_tally(
            table, torch.from_numpy(codes).to(device),
            torch.from_numpy(lengths).to(device), canonical)
        work.append((distinct, rows.shape[0]))
        if times:
            counts.index_add_(0, rows, n * times)
    return counts, work


def compare(got_np, expected):
    """The numbers compared, each with its limit: rows whose count
    differs, and the gap between the two counts' sums (both exact)."""
    got = torch.from_numpy(got_np).to(expected.device)
    if got.shape != expected.shape:
        return {"rows_differing": (int(expected.shape[0]), 0),
                "count_sum_gap": (int(expected.sum()), 0)}
    return {"rows_differing": (int((got != expected).sum()), 0),
            "count_sum_gap": (int((got.sum() - expected.sum()).abs()), 0)}
