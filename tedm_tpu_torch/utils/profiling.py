"""Profiling hooks (port of ``tedm_tpu/utils/profiling.py``).

``StepTrace`` is the trainers' ``--profile_dir``: a ``torch.profiler``
session opened at step 10 and closed after step 15, once the card has
finished, as the JAX loops do (tedm_tpu/trainers/common.py:244-252). It
writes a Chrome-trace JSON file (``*.pt.trace.json``) of host activity,
and of the card's kernels on a CUDA device, that TensorBoard's profiler
plugin and Perfetto read.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


class StepTrace:
    """A trace of training steps ``first`` to ``last`` into ``log_dir`` (no-op
    without one): call ``before(step)`` ahead of each step and
    ``after(step)`` behind it. Leaving the ``with`` block ends a trace still
    open, so a run shorter than ``last`` steps writes its steps too."""

    def __init__(self, log_dir: Optional[str], device: Optional[torch.device] = None,
                 first: int = 10, last: int = 15):
        self.log_dir, self.first, self.last = log_dir, first, last
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.device = device
        self.prof = None

    def before(self, step: int) -> None:
        if self.log_dir and step == self.first:
            from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            os.makedirs(self.log_dir, exist_ok=True)
            self.prof = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(self.log_dir))
            self.prof.start()

    def after(self, step: int) -> None:
        if self.prof is not None and step == self.last:
            self.close()

    def close(self) -> None:
        """Wait for the card, then end the session and write its trace."""
        if self.prof is not None:
            if self.cuda:
                torch.cuda.synchronize(self.device)
            self.prof.stop()
            self.prof = None

    def __enter__(self) -> "StepTrace":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
