"""``KDF_PROFILE=<dir>``: a ``torch.profiler`` trace around a whole run.

The port's counterpart of the JAX pipelines' ``jax.profiler`` trace
(reference vcf/pipeline.py:786–800, discovery/pipeline.py:1912–1926),
the same variable: CPU activity, plus CUDA activity when the run's
device is a card.  The trace is written into the directory in the
TensorBoard layout (``<host>_<pid>.<time>.pt.trace.json``, Chrome trace
JSON), one file a process.  The run also has the port's tracing on
(:mod:`.tracing`), so its spans are annotations on that trace, and
writes their records and the counters beside it as
``kdf_tracing.<host>_<pid>.json`` (:func:`.tracing.collect`, stamped in
Unix nanoseconds like the trace's events).
"""

import json
import logging
import os
import socket

import torch
from torch.profiler import ProfilerActivity

from kmer_denovo_filter_tpu_torch import tracing

logger = logging.getLogger(__name__)


def run_profiled(run, device):
    """``run()``, under ``torch.profiler`` and with tracing on when
    ``KDF_PROFILE`` names a directory; the trace and the spans are
    written there even when *run* raises."""
    profile_dir = os.environ.get("KDF_PROFILE")
    if not profile_dir:
        return run()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    was_on = tracing.enabled()
    if not was_on:
        tracing.reset()
        tracing.enable()
    try:
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    profile_dir)):
            return run()
    finally:
        if not was_on:
            tracing.disable()
        path = os.path.join(
            profile_dir,
            f"kdf_tracing.{socket.gethostname()}_{os.getpid()}.json")
        os.makedirs(profile_dir, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(tracing.collect(), fh)
        logger.info("[Profile] torch trace and spans written to %s",
                    profile_dir)
