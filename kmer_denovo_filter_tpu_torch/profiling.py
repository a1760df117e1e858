"""``KDF_PROFILE=<dir>``: a ``torch.profiler`` trace around a whole run.

The port's counterpart of the JAX pipelines' ``jax.profiler`` trace
(reference vcf/pipeline.py:786–800, discovery/pipeline.py:1912–1926),
the same variable: CPU activity, plus CUDA activity when the run's
device is a card.  The trace is written into the directory in the
TensorBoard layout (``<host>_<pid>.<time>.pt.trace.json``, Chrome trace
JSON), one file a process.
"""

import logging
import os

import torch
from torch.profiler import ProfilerActivity

logger = logging.getLogger(__name__)


def run_profiled(run, device):
    """``run()``, under ``torch.profiler`` when ``KDF_PROFILE`` names a
    directory; the trace is written there even when *run* raises."""
    profile_dir = os.environ.get("KDF_PROFILE")
    if not profile_dir:
        return run()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    profile_dir)):
            return run()
    finally:
        logger.info("[Profile] torch trace written to %s", profile_dir)
