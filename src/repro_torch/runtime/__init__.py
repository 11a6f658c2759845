"""Execution runtime: process topology under every other subsystem.

* ``procs`` -- the process primitives with nothing but the standard
  library: ``file_lock`` (fcntl advisory locks serializing
  shared-filesystem JSON), ``Heartbeat`` / ``heartbeat_age`` (liveness
  files), ``CrashPoint`` (SIGKILL fault injection) and ``child_env``
  (a spawned interpreter's environment).
* ``workers`` -- the multi-process target-generation fleet (worker CLI,
  ``Supervisor`` with stale-claim stealing and respawn, engine factory
  specs; the backend of ``pipeline.generate_sharded(processes=N)``) and
  the elastic trainers' roster (``TrainerMembership``,
  ``LaneCrashPlan``).

The reference's ``env`` and ``cluster`` layers come with ROADMAP Queue 1,
step 8b.  ``workers`` is re-exported lazily, as in the reference, so
importing this package never pulls the pipeline and the store in.
"""
from repro_torch.runtime.procs import (CrashPoint, Heartbeat, beat,
                                       child_env, file_lock, heartbeat_age,
                                       heartbeat_path, repro_pythonpath)

_LAZY = {
    "Supervisor": "repro_torch.runtime.workers",
    "run_supervised_generation": "repro_torch.runtime.workers",
    "linear_probe_engine": "repro_torch.runtime.workers",
    "teacher_engine": "repro_torch.runtime.workers",
    "TrainerMembership": "repro_torch.runtime.workers",
    "LaneCrashPlan": "repro_torch.runtime.workers",
}

__all__ = sorted(["file_lock", "Heartbeat", "CrashPoint", "beat",
                  "heartbeat_age", "heartbeat_path", "child_env",
                  "repro_pythonpath", *_LAZY])


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
