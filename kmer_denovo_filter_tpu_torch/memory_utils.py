# Copied from kmer_denovo_filter_tpu/memory_utils.py
"""Memory / disk / subprocess observability (reference core/memory_utils.py).

Adds a device-memory probe for the TPU engine on top of the
/proc-based host metrics the reference logs at module boundaries.
"""

import logging
import os

logger = logging.getLogger(__name__)


def log_disk_usage(path, label=""):
    try:
        stat = os.statvfs(path)
        total_gb = (stat.f_blocks * stat.f_frsize) / (1024 ** 3)
        avail_gb = (stat.f_bavail * stat.f_frsize) / (1024 ** 3)
        logger.info(
            "  [Disk] %s — %.1f GB used / %.1f GB total "
            "(%.1f GB available) — %s",
            label, total_gb - avail_gb, total_gb, avail_gb, path)
    except OSError:
        pass


def log_dir_size(path, label=""):
    try:
        total = sum(e.stat().st_size for e in os.scandir(path)
                    if e.is_file(follow_symlinks=False))
        logger.info("  [TmpDir] %s — %.2f GB in %s",
                    label, total / (1024 ** 3), path)
    except OSError:
        pass


def log_memory(label=""):
    """Log current/peak RSS from /proc/self/status (Linux)."""
    try:
        info = {}
        try:
            with open("/proc/self/status") as fh:
                for line in fh:
                    if line.startswith("VmRSS:"):
                        info["RSS"] = int(line.split()[1]) / (1024 * 1024)
                    elif line.startswith("VmPeak:"):
                        info["Peak"] = int(line.split()[1]) / (1024 * 1024)
        except FileNotFoundError:
            pass
        if not info:
            import resource
            ru = resource.getrusage(resource.RUSAGE_SELF)
            info["Peak_RSS"] = ru.ru_maxrss / (1024 * 1024)
        if info:
            parts = [f"{k}={v:.2f} GB" for k, v in sorted(info.items())]
            logger.info("  [Memory] %s — %s", label, ", ".join(parts))
    except Exception:
        pass


def log_subprocess_memory(proc, label=""):
    """Log a subprocess's RSS (Linux; used by the Kraken2 stage)."""
    if proc is None or proc.poll() is not None:
        return
    try:
        rss_kb = 0
        with open(f"/proc/{proc.pid}/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    rss_kb = int(line.split()[1])
                    break
        if rss_kb:
            logger.info("  [SubprocessMem] %s (pid=%d) — RSS=%.2f GB",
                        label, proc.pid, rss_kb / (1024 * 1024))
    except Exception:
        pass


def get_available_memory_gb():
    """(total_gb, available_gb) from /proc/meminfo; Nones when unknown."""
    total_gb = None
    available_gb = None
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemTotal:"):
                    total_gb = int(line.split()[1]) / (1024 * 1024)
                elif line.startswith("MemAvailable:"):
                    available_gb = int(line.split()[1]) / (1024 * 1024)
        if total_gb is not None:
            return total_gb, available_gb
    except OSError:
        pass
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
        if pages > 0 and page_size > 0:
            total_gb = pages * page_size / (1024 ** 3)
    except (ValueError, OSError, AttributeError):
        pass
    return total_gb, available_gb


def log_children_memory(label=""):
    """Aggregate RSS across child processes (Linux)."""
    try:
        my_pid = os.getpid()
        total_rss_kb = 0
        n_children = 0
        try:
            with open(f"/proc/{my_pid}/task/{my_pid}/children") as fh:
                child_pids = fh.read().split()
        except OSError:
            child_pids = []
        for cpid in child_pids:
            try:
                with open(f"/proc/{cpid}/status") as fh:
                    for line in fh:
                        if line.startswith("VmRSS:"):
                            total_rss_kb += int(line.split()[1])
                            n_children += 1
                            break
            except OSError:
                continue
        if n_children:
            logger.info(
                "  [ChildProcessMem] %s — %d children, total RSS=%.2f GB",
                label, n_children, total_rss_kb / (1024 * 1024))
    except Exception:
        pass


def log_device_memory(label="", device=None):
    """Log the CUDA caching allocator's stats for *device* (the current
    CUDA device when None); a no-op for a CPU device or without CUDA."""
    try:
        import torch
        if not torch.cuda.is_available():
            return
        if device is not None and torch.device(device).type != "cuda":
            return
        stats = torch.cuda.memory_stats(device)
        used = stats.get("allocated_bytes.all.current", 0) / (1024 ** 3)
        total = torch.cuda.get_device_properties(
            device if device is not None
            else torch.cuda.current_device()).total_memory / (1024 ** 3)
        logger.info("  [DeviceMem] %s — %s: %.2f / %.2f GB",
                    label, device if device is not None else "cuda",
                    used, total)
    except Exception:
        pass
