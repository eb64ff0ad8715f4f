"""Profiling / tracing for the proving pipeline.

The reference has no timers around proving at all (only Substrate's
informant logger, src/cli.rs:65); the port's observability is (1) device
traces through ``torch.profiler`` (CPU activity, plus CUDA activity where a
card is present), exported as a Chrome trace, and (2) host-side stage
timings, each stage also a named region of that trace.  The trace is
zero-cost when disabled.

Usage:
    with device_trace("/tmp/trace"):      # op-level host + device trace
        prover.prove(assignments)

    rec = StageRecorder()
    with rec.stage("msm_a"):
        ...
    rec.timings    # -> {"msm_a": 6.1, ...}

``ZEROCHAIN_TRACE=<dir>`` turns on a device trace around each
``ConfidentialProver.prove`` call without touching call sites.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """torch.profiler trace context; no-op if log_dir is falsy.

    On exit the trace is written into ``log_dir`` as a Chrome trace
    (``trace_<pid>_<n>.json``, viewable in chrome://tracing or Perfetto),
    with the time of every host op and, where a card is present, of every
    kernel on it."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    n = len([p for p in os.listdir(log_dir) if p.startswith("trace_")])
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


class StageRecorder:
    """Wall-clock stage timings, in insertion order, in ``timings``.

    Each ``stage`` context adds its seconds under its name and is a named
    region (``annotate``) in a torch.profiler trace.  ``sync``, where
    given, is called at the end of every stage, so that the stage's time
    bounds the device work it queued (e.g. ``torch.cuda.synchronize``)."""

    def __init__(self, sync=None):
        self.timings: dict[str, float] = {}
        self._sync = sync

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with annotate(name):
                yield
                if self._sync is not None:
                    self._sync()
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + (
                time.perf_counter() - t0
            )


def trace_dir_from_env() -> str | None:
    return os.environ.get("ZEROCHAIN_TRACE") or None


def annotate(name: str):
    """Named region visible in torch.profiler traces."""
    from torch.profiler import record_function

    return record_function(name)
