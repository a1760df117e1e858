# Copied from kmer_denovo_filter_tpu/utils.py
"""Shared utilities: formatting, system checks, FASTA k-mer I/O, validation.

Functional twin of reference utils.py (350 LoC) minus the
Jellyfish-specific helpers, which have no analog in the device engine.
"""

import logging
import os
import queue
import shutil
import sys
import threading

logger = logging.getLogger(__name__)


# ── Input-pipeline prefetch ────────────────────────────────────────

_PREFETCH_END = object()


def prefetch_batches(iterable, depth=2):
    """Iterate *iterable* on a background thread, *depth* items ahead.

    The device-feed loops are a three-stage pipeline: host BAM decode →
    pad/stage → async device step.  The deferred-overflow engine
    contract already keeps the device busy across batches; this
    decouples the decode stage too, so batch i+1 inflates/unpacks
    while batch i is being staged and dispatched (the analog of the
    ``samtools | jellyfish`` pipe boundary, reference
    core/jellyfish_wrappers.py:189–200).

    Exceptions raised by the producer re-raise at the consumer's next
    step; abandoning the generator stops the producer promptly.
    """
    q = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def _put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce():
        try:
            for item in iterable:
                if not _put(item):
                    return
            _put(_PREFETCH_END)
        except BaseException as exc:  # re-raised by the consumer
            _put(exc)

    worker = threading.Thread(target=_produce, daemon=True,
                              name="kdf-prefetch")
    worker.start()
    try:
        while True:
            item = q.get()
            if item is _PREFETCH_END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


# ── Formatting ─────────────────────────────────────────────────────


def format_elapsed(seconds):
    """Human-readable elapsed time (reference utils.py:49–60 format)."""
    if seconds < 60:
        return f"{seconds:.1f}s"
    if seconds < 3600:
        return f"{int(seconds // 60)}m {seconds % 60:.1f}s"
    hours = int(seconds // 3600)
    minutes = int((seconds % 3600) // 60)
    return f"{hours}h {minutes}m {seconds % 60:.0f}s"


def format_file_size(path):
    """Human-readable file size, '?' when unavailable."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return "?"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if size < 1024:
            return f"{size:.1f} {unit}"
        size /= 1024
    return f"{size:.1f} PB"


# ── System checks ──────────────────────────────────────────────────


def check_tool(name):
    """True when an external tool is on PATH (used only for kraken2)."""
    return shutil.which(name) is not None


def is_tmpfs(path):
    """True when *path* lives on a tmpfs filesystem (Linux)."""
    try:
        real = os.path.realpath(path)
        best_mount = ""
        best_fstype = ""
        with open("/proc/mounts") as fh:
            for line in fh:
                parts = line.split()
                if len(parts) >= 3:
                    mnt, fstype = parts[1], parts[2]
                    if real.startswith(mnt) and len(mnt) > len(best_mount):
                        best_mount, best_fstype = mnt, fstype
        return best_fstype == "tmpfs"
    except OSError:
        return False


def resolve_tmp_dir(tmp_dir, fallback_dir):
    """Pick the temp-file root (reference utils.py:115–142 semantics)."""
    resolved = getattr(tmp_dir, "tmp_dir", tmp_dir)
    if resolved:
        os.makedirs(resolved, exist_ok=True)
        return os.path.abspath(resolved)
    tmp_root = os.path.join(fallback_dir, "kmer_denovo_tmp")
    os.makedirs(tmp_root, exist_ok=True)
    return os.path.abspath(tmp_root)


# ── FASTA k-mer I/O (for interchange / debugging artifacts) ────────


def write_kmer_fasta(kmers, filepath):
    with open(filepath, "w") as fh:
        for i, kmer in enumerate(kmers):
            fh.write(f">{i}\n{kmer}\n")


def load_kmers_from_fasta(fasta_path):
    kmers = set()
    with open(fasta_path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line and not line.startswith(">"):
                kmers.add(line)
    return kmers


def estimate_fasta_sequence_count(fasta_path, sample_lines=1000):
    """(count, extrapolated) estimate of FASTA entries from a prefix.

    Reads up to *sample_lines* lines; when the file is larger than the
    sample, the header density of the sampled bytes is scaled to the
    file size (the reference's sampling estimator, ref utils.py:173–227).
    """
    if sample_lines <= 0:
        raise ValueError("sample_lines must be > 0")
    try:
        file_size = os.path.getsize(fasta_path)
    except OSError:
        file_size = 0
    if not file_size:
        return 0, False

    headers = bytes_seen = 0
    exhausted = False
    with open(fasta_path, "rb") as fh:
        for _ in range(sample_lines):
            line = fh.readline()
            if not line:
                exhausted = True
                break
            bytes_seen += len(line)
            headers += line.lstrip().startswith(b">")
    if not headers:
        return 0, False
    if exhausted:
        # whole file sampled — the count is exact
        return headers, False
    scaled = int(round(headers * file_size / bytes_seen))
    return max(scaled, 1), True


# ── Input validation (reference utils.py:230–350 error matrix) ─────


def validate_inputs(args):
    """Validate pipeline inputs, exiting with per-problem errors."""
    errors = []

    required = [
        ("Child BAM/CRAM (--child)", args.child),
        ("Mother BAM/CRAM (--mother)", args.mother),
        ("Father BAM/CRAM (--father)", args.father),
    ]
    _vcf = getattr(args, "vcf", None)
    if _vcf is not None:
        required.append(("Input VCF (--vcf)", _vcf))
    for label, path in required:
        if not os.path.isfile(path):
            errors.append(f"{label}: file not found: {path}")

    if args.ref_fasta is not None and not os.path.isfile(args.ref_fasta):
        errors.append(
            f"Reference FASTA (--ref-fasta): file not found: {args.ref_fasta}")

    for label, path in [("--child", args.child), ("--mother", args.mother),
                        ("--father", args.father)]:
        if path.endswith(".cram") and args.ref_fasta is None:
            errors.append(
                f"{label} is a CRAM file but --ref-fasta was not provided")

    for label, path in [("--child", args.child), ("--mother", args.mother),
                        ("--father", args.father)]:
        if os.path.isfile(path):
            candidates = [path + ".bai", path + ".csi", path + ".crai"]
            alt = path.rsplit(".", 1)[0] + ".bai" if "." in path else None
            if alt:
                candidates.append(alt)
            if not any(os.path.isfile(p) for p in candidates):
                errors.append(
                    f"{label}: no index found for {path} "
                    f"(expected .bai, .csi, or .crai)")

    if args.kmer_size < 3:
        errors.append(f"--kmer-size must be >= 3, got {args.kmer_size}")
    if args.kmer_size > 201:
        errors.append(f"--kmer-size must be <= 201, got {args.kmer_size}")
    if args.kmer_size % 2 == 0:
        errors.append(
            f"--kmer-size should be odd for canonical k-mer symmetry, "
            f"got {args.kmer_size}")
    if args.min_baseq < 0:
        errors.append(f"--min-baseq must be >= 0, got {args.min_baseq}")
    if args.threads < 1:
        errors.append(f"--threads must be >= 1, got {args.threads}")

    if _vcf is None:
        if args.ref_fasta is None and getattr(args, "ref_jf", None) is None:
            errors.append(
                "Discovery mode requires --ref-fasta (or --ref-jf) "
                "to subtract reference k-mers")
        ref_jf = getattr(args, "ref_jf", None)
        if ref_jf is not None and not os.path.isfile(ref_jf):
            errors.append(
                f"Reference Jellyfish index (--ref-jf): file not found: "
                f"{ref_jf}")
        min_child_count = getattr(args, "min_child_count", 3)
        if min_child_count < 1:
            errors.append(
                f"--min-child-count must be >= 1, got {min_child_count}")

    if _vcf is not None:
        if args.min_mapq < 0:
            errors.append(f"--min-mapq must be >= 0, got {args.min_mapq}")

    if errors:
        for err in errors:
            logger.error("Validation error: %s", err)
        sys.exit(1)
