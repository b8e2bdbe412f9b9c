"""Graceful shutdown for long trainings (own copy of
``tedm_tpu/utils/interrupt.py``).

The reference has no failure handling at all (SURVEY §5: 'Training
crashes are fatal'). Here SIGTERM/SIGINT set a flag the training loops
poll once per step; on the next step boundary they save an
``interrupted`` checkpoint (full train state + config) and return, so a
preempted job resumes with ``--resume_path <logdir>/interrupted``.

Usage:
    with graceful_shutdown() as should_stop:
        for batch in ...:
            ...
            if should_stop():
                save_checkpoint(f"{log_dir}/interrupted", state, config)
                break
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Callable, Iterator


@contextlib.contextmanager
def graceful_shutdown() -> Iterator[Callable[[], bool]]:
    stop = threading.Event()
    prev = {}
    installed = []

    def restore():
        for sig in installed:
            signal.signal(sig, prev[sig])
        installed.clear()

    def handler(signum, frame):
        print(f"[interrupt] signal {signum} received; will checkpoint and "
              "stop at the next step boundary (signal again to force)",
              flush=True)
        stop.set()
        # escalation: restore previous handlers so a SECOND signal kills a
        # step that is stuck inside a long device call
        restore()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:  # only the main thread may set handlers
            prev[sig] = signal.signal(sig, handler)
            installed.append(sig)
        except ValueError:
            pass
    try:
        yield stop.is_set
    finally:
        restore()
