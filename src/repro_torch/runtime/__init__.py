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
* ``env`` -- the ``REPRO_*`` bootstrap applied before the first CUDA
  initialization (``EnvConfig``, ``bootstrap``, ``describe``).
* ``cluster`` -- process groups over ``torch.distributed``
  (``ClusterConfig``, ``initialize``) and the worker mesh of ranks the
  GTCShardMap / BMUFShardMap strategies run on (``worker_mesh``,
  ``WorkerMesh``, ``PAPER_TOPOLOGIES``, ``topology_mesh``).

``workers``, ``env`` and ``cluster`` are re-exported lazily, as in the
reference, so importing this package pulls in neither torch nor the
pipeline and the store.
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
    "EnvConfig": "repro_torch.runtime.env",
    "bootstrap": "repro_torch.runtime.env",
    "bootstrap_from_env": "repro_torch.runtime.env",
    "describe": "repro_torch.runtime.env",
    "ClusterConfig": "repro_torch.runtime.cluster",
    "ClusterInfo": "repro_torch.runtime.cluster",
    "initialize": "repro_torch.runtime.cluster",
    "WorkerMesh": "repro_torch.runtime.cluster",
    "worker_mesh": "repro_torch.runtime.cluster",
    "widest_divisor": "repro_torch.runtime.cluster",
    "PAPER_TOPOLOGIES": "repro_torch.runtime.cluster",
    "topology_mesh": "repro_torch.runtime.cluster",
}

__all__ = sorted(["file_lock", "Heartbeat", "CrashPoint", "beat",
                  "heartbeat_age", "heartbeat_path", "child_env",
                  "repro_pythonpath", *_LAZY])


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
