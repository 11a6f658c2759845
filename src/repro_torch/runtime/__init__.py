"""Execution runtime, single-process slice.

``procs`` — the process primitives with nothing but the standard
library: ``file_lock`` (fcntl advisory locks serializing
shared-filesystem JSON), ``Heartbeat`` / ``heartbeat_age`` (liveness
files) and ``CrashPoint`` (SIGKILL fault injection).  The reference's
``env``, ``workers`` and ``cluster`` layers come with the multi-process
runtime (ROADMAP Queue 1, step 8).
"""
from repro_torch.runtime.procs import (CrashPoint, Heartbeat, beat,
                                       file_lock, heartbeat_age,
                                       heartbeat_path)

__all__ = ["file_lock", "Heartbeat", "CrashPoint", "beat", "heartbeat_age",
           "heartbeat_path"]
