"""Canonical k-mer keys in plain PyTorch, written apart from the port.

A k-mer over the codes 0..3 (A, C, G, T) is the big-endian string of its
2-bit bases, left-aligned in W = ceil(2k / 32) 32-bit words: word i holds
bases 16i .. 16i + 15, the bits past base k - 1 zero.  That is the form
the port takes its tables in, (M, W) ``uint32``.  Here a key is carried
as C = ceil(W / 2) int64 *columns*: column c is the word pair
(w[2c], w[2c + 1]) as ``(w[2c] - 2**31) * 2**32 + w[2c + 1]``, a signed
number whose order is the pair's unsigned order, so comparing the
columns left to right compares the base strings.  A key's canonical form
is the lesser of its forward string and its reverse complement.

The recipes (:mod:`portbench.recipes`) make tables with these functions
and the plain references (:mod:`portbench.reference`) recount with them.
"""

import torch

BASES_PER_WORD = 16
_HALF = 1 << 31
_WORD = 1 << 32


def words_per_kmer(k):
    """W, the 32-bit words of a k-mer: ceil(2k / 32)."""
    return -(-k // BASES_PER_WORD)


def columns_per_kmer(k):
    """C, the int64 columns of a k-mer: ceil(W / 2)."""
    return -(-words_per_kmer(k) // 2)


def window_words(codes, k):
    """Words of every k-window of each row of *codes*.

    *codes*: (R, L) integer codes (any value; windows holding a code
    above 3 are the caller's to drop).  Returns (R, L - k + 1, W) int64,
    each entry in [0, 2**32)."""
    codes = codes.to(torch.int64)
    n_win = codes.shape[1] - k + 1
    w = words_per_kmer(k)
    out = torch.zeros(codes.shape[0], n_win, w, dtype=torch.int64,
                      device=codes.device)
    for i in range(w):
        word = out[:, :, i]
        for t in range(BASES_PER_WORD):
            j = BASES_PER_WORD * i + t
            if j >= k:
                break
            word |= (codes[:, j:j + n_win] & 3) << (2 * (BASES_PER_WORD - 1 - t))
    return out


def pack(words):
    """(..., W) words → (..., C) int64 columns (see the module)."""
    w = words.shape[-1]
    if w % 2:
        words = torch.cat([words, torch.zeros_like(words[..., :1])], -1)
    hi = words[..., 0::2]
    lo = words[..., 1::2]
    return (hi - _HALF) * _WORD + lo


def unpack(cols, w):
    """(..., C) columns → (..., W) int64 words, the inverse of :func:`pack`."""
    hi = (cols >> 32) + _HALF
    lo = cols & (_WORD - 1)
    return torch.stack([hi, lo], -1).flatten(-2)[..., :w]


def less(a, b):
    """Lexicographic a < b over the last dimension (int64 columns)."""
    lt = a[..., -1] < b[..., -1]
    for c in range(a.shape[-1] - 2, -1, -1):
        lt = (a[..., c] < b[..., c]) | ((a[..., c] == b[..., c]) & lt)
    return lt


def window_keys(codes, lengths, k, canonical=True):
    """Packed keys of every k-window of each read, and which are valid.

    *codes*: (R, L) codes; *lengths*: (R,) read lengths.  A window is
    valid when it lies inside its read and holds no code above 3.
    Returns ((R, L - k + 1, C) int64 columns, (R, L - k + 1) bool).  With
    *canonical* False the keys are the forward strings alone."""
    codes = codes.to(torch.int64)
    n_win = codes.shape[1] - k + 1
    fwd = pack(window_words(codes, k))
    if canonical:
        # window s of the reverse complement is window n_win - 1 - s here
        rc = pack(window_words(3 - codes.flip(1), k)).flip(1)
        fwd = torch.where(less(rc, fwd).unsqueeze(-1), rc, fwd)
    bad = torch.cumsum((codes > 3).to(torch.int32), 1)
    bad = torch.cat([torch.zeros_like(bad[:, :1]), bad], 1)
    starts = torch.arange(n_win, device=codes.device)
    valid = ((bad[:, k:] - bad[:, :n_win]) == 0) & (
        starts.unsqueeze(0) + k <= lengths.to(codes.device).unsqueeze(1))
    return fwd, valid


def lexsort(cols):
    """Permutation that sorts (N, C) columns lexicographically."""
    order = torch.argsort(cols[:, -1], stable=True)
    for c in range(cols.shape[1] - 2, -1, -1):
        order = order[torch.argsort(cols[order, c], stable=True)]
    return order


def unique_counts(cols):
    """(distinct (U, C) columns in order, (U,) int64 multiplicities)."""
    if cols.shape[0] == 0:
        return cols, torch.zeros(0, dtype=torch.int64, device=cols.device)
    s = cols[lexsort(cols)]
    new = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    new[1:] = (s[1:] != s[:-1]).any(1)
    first = torch.nonzero(new).flatten()
    ends = torch.cat([first[1:], first.new_tensor([s.shape[0]])])
    return s[first], ends - first


def to_uint32_words(cols, k):
    """(M, C) columns → (M, W) int32 words whose bits are the uint32
    words (view the host copy as ``uint32``)."""
    words = unpack(cols, words_per_kmer(k))
    return (words - ((words >> 31) << 32)).to(torch.int32)


def from_uint32_words(words_i32, k):
    """(M, W) int32 words holding uint32 bits → (M, C) columns."""
    words = words_i32.to(torch.int64) & (_WORD - 1)
    if words.shape[1] != words_per_kmer(k):
        raise ValueError(f"expected (M, {words_per_kmer(k)}) words for "
                         f"k={k}, got {tuple(words.shape)}")
    return pack(words)
