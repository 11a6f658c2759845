"""``torch.distributed`` launch paths and the worker mesh of ranks.

The twin of the reference's ``runtime/cluster.py``.  The paper's two
trainers are defined by their topology -- BMUF across 64 GPUs, GTC
sequence training across 16 -- and this module is where that topology
becomes a process group plus a mesh of ranks:

* :class:`ClusterConfig` carries (coordinator address, process count,
  process id), resolved from ``REPRO_COORDINATOR`` /
  ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` (falling back to the
  ``JAX_*`` spellings the reference reads) or from a ``--cluster
  host:port,N,i`` flag (``--cluster env`` reads the variables), and the
  one field torch needs, ``backend`` (``REPRO_DIST_BACKEND``).
* :func:`initialize` calls ``torch.distributed.init_process_group`` once,
  with an explicit ``tcp://host:port``, world size, rank and timeout (a
  lost rank fails the run instead of hanging it), and **is a no-op for a
  single process** unless a backend is named: every existing entry point
  runs unchanged, and ``REPRO_DIST_BACKEND=nccl`` at N = 1 runs the
  collectives through NCCL on one rank.
* :func:`worker_mesh` builds the :class:`WorkerMesh` the GTCShardMap and
  BMUFShardMap strategies run on: the widest axis the worker count W
  divides onto the ranks, worker ``i`` on rank ``i // (W / n)`` as in the
  reference's layout.  Without :func:`initialize` it is a one-rank mesh
  holding all W lanes, the reference's one-device mesh: the same math,
  pinned bitwise in tests.

Differences from the reference, on purpose: the ``backend`` field; a rank
is one process with one device (``cuda:(rank % device_count)``, or the
host), where the reference's one controller drives a mesh of devices;
ranks past the axis hold no lane and take part in every collective with
zeros (an integer sum with 0 is exact, and they receive the same update);
a second, gloo group carries the host-side traffic (checkpoint gathers,
metrics, barriers), since NCCL moves no CPU tensor and gloo gathers no
CUDA tensor.  NCCL refuses two ranks on one device, so ``nccl`` with
more ranks than devices raises before ``init_process_group`` and names
``gloo``, which stages CUDA tensors through the host.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, List, Mapping, Optional, Tuple

BACKENDS = ("nccl", "gloo")
TIMEOUT_S = 120.0          # init and every collective: a lost rank fails


@dataclass(frozen=True)
class ClusterConfig:
    """One process's view of the fleet.  num_processes <= 1 means
    single-process: :func:`initialize` is then a no-op unless a
    ``backend`` is named."""

    coordinator_address: str = ""     # "host:port" of process 0
    num_processes: int = 1
    process_id: int = 0
    backend: str = ""                 # "nccl" | "gloo"; "": by device

    @classmethod
    def from_env(cls, environ: Optional[Mapping[str, str]] = None
                 ) -> "ClusterConfig":
        e = os.environ if environ is None else environ

        def get(*names, default=""):
            for n in names:
                if e.get(n):
                    return e[n]
            return default

        return cls(
            coordinator_address=get("REPRO_COORDINATOR",
                                    "JAX_COORDINATOR_ADDRESS"),
            num_processes=int(get("REPRO_NUM_PROCESSES",
                                  "JAX_NUM_PROCESSES", default="1")),
            process_id=int(get("REPRO_PROCESS_ID", "JAX_PROCESS_ID",
                               default="0")),
            backend=_backend(e))

    @classmethod
    def from_spec(cls, spec: str,
                  environ: Optional[Mapping[str, str]] = None
                  ) -> "ClusterConfig":
        """Parse a ``--cluster`` flag value.

        ``"env"`` -> :meth:`from_env`;
        ``"host:port,N,i"`` -> explicit coordinator, fleet size, rank
        (the backend still from ``REPRO_DIST_BACKEND``).
        """
        if spec.strip().lower() in ("", "env"):
            return cls.from_env(environ)
        parts = [p.strip() for p in spec.split(",")]
        if len(parts) != 3:
            raise ValueError(
                f"--cluster spec {spec!r}: want 'host:port,num_procs,"
                f"process_id' or 'env'")
        return cls(coordinator_address=parts[0],
                   num_processes=int(parts[1]), process_id=int(parts[2]),
                   backend=_backend(os.environ if environ is None
                                    else environ))

    @property
    def multi_process(self) -> bool:
        """Whether :func:`initialize` starts a process group."""
        return self.num_processes > 1 or bool(self.backend)

    def validate(self):
        if self.num_processes > 1:
            if not self.coordinator_address:
                raise ValueError(
                    "multi-process cluster needs a coordinator address")
            if not 0 <= self.process_id < self.num_processes:
                raise ValueError(
                    f"process_id {self.process_id} outside "
                    f"[0, {self.num_processes})")
        if self.backend and self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r}: want one of "
                             f"{BACKENDS} (REPRO_DIST_BACKEND)")
        if self.backend and not self.coordinator_address:
            raise ValueError("a named backend starts a process group, "
                             "which needs a coordinator address")


def _backend(environ: Mapping[str, str]) -> str:
    return environ.get("REPRO_DIST_BACKEND", "").strip().lower()


@dataclass(frozen=True)
class ClusterInfo:
    """What :func:`initialize` actually did."""

    initialized: bool                 # did init_process_group run
    process_index: int
    process_count: int
    backend: str = ""
    device: Optional[str] = None      # this rank's device (None: no group)

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


_ACTIVE: Optional[ClusterInfo] = None
_HOST_GROUP = None


def initialize(cfg: Optional[ClusterConfig] = None, *,
               device="cuda") -> ClusterInfo:
    """Bring this process into the fleet (idempotent).

    Single-process configs without a named backend (the default, and
    every existing test and example) return a no-op ClusterInfo without
    touching ``torch.distributed``.  Otherwise the rank's device is
    ``cuda:(rank % device_count)`` for a CUDA ``device`` (the host for
    ``cpu``), the backend ``cfg.backend`` or, unnamed, ``nccl`` on CUDA
    and ``gloo`` on the host, and ``init_process_group`` runs once with
    a ``TIMEOUT_S`` timeout; a second call returns the recorded info.
    ``nccl`` with more ranks than devices, or on the host, raises before
    any process group exists.
    """
    global _ACTIVE, _HOST_GROUP
    if _ACTIVE is not None:
        return _ACTIVE
    cfg = cfg or ClusterConfig.from_env()
    cfg.validate()
    if not cfg.multi_process:
        _ACTIVE = ClusterInfo(initialized=False, process_index=0,
                              process_count=1)
        return _ACTIVE
    import torch
    import torch.distributed as dist

    from repro_torch.kernels._dispatch import resolve_device
    dev = resolve_device(device)
    backend = cfg.backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        n_dev = torch.cuda.device_count()
        if backend == "nccl" and cfg.num_processes > n_dev:
            raise ValueError(
                f"nccl cannot run {cfg.num_processes} ranks on {n_dev} "
                f"CUDA device(s): two ranks would share a device; set "
                f"REPRO_DIST_BACKEND=gloo to stage the collectives "
                f"through the host")
        dev = torch.device("cuda", cfg.process_id % n_dev)
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("nccl runs on CUDA devices only; use gloo on the "
                         "host")
    timeout = timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(backend,
                            init_method=f"tcp://{cfg.coordinator_address}",
                            world_size=cfg.num_processes,
                            rank=cfg.process_id, timeout=timeout)
    _HOST_GROUP = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo", timeout=timeout))
    _ACTIVE = ClusterInfo(initialized=True, process_index=dist.get_rank(),
                          process_count=dist.get_world_size(),
                          backend=backend, device=str(dev))
    return _ACTIVE


def active() -> Optional[ClusterInfo]:
    """The ClusterInfo of a prior :func:`initialize`, or None."""
    return _ACTIVE


def world_size() -> int:
    """The number of ranks of an initialized fleet (1 without one)."""
    return _ACTIVE.process_count if _ACTIVE is not None else 1


def is_leader() -> bool:
    """Whether this process is rank 0 of the fleet (or alone): the one
    that writes files every rank shares."""
    return _ACTIVE is None or _ACTIVE.process_index == 0


def barrier():
    """Wait for every rank over the host group (a no-op alone)."""
    if _HOST_GROUP is not None:
        import torch.distributed as dist
        dist.barrier(group=_HOST_GROUP)


def on_leader(write):
    """``write()`` on rank 0 while the other ranks wait at a barrier,
    so no two ranks write one file and none reads it early; alone, just
    ``write()``.  Returns its result on rank 0, None elsewhere."""
    out = write() if is_leader() else None
    barrier()
    return out


def all_gather_object(obj) -> List[Any]:
    """Every rank's ``obj``, in rank order, over the host group
    (``[obj]`` alone)."""
    if _HOST_GROUP is None:
        return [obj]
    import torch.distributed as dist
    out = [None] * _ACTIVE.process_count
    dist.all_gather_object(out, obj, group=_HOST_GROUP)
    return out


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank, over the host group (``obj``
    alone); the other ranks' ``obj`` is ignored."""
    if _HOST_GROUP is None:
        return obj
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_HOST_GROUP)
    return box[0]


def host_sum(x: float) -> float:
    """A host number summed over the ranks (``x`` alone)."""
    return float(sum(all_gather_object(float(x))))


def _reset_for_tests():
    global _ACTIVE, _HOST_GROUP
    if _ACTIVE is not None and _ACTIVE.initialized:
        import torch.distributed as dist
        dist.destroy_process_group()
    _ACTIVE = None
    _HOST_GROUP = None


# ----------------------------------------------------------------- meshes

def widest_divisor(n_workers: int, n_devices: int) -> int:
    """The largest device count <= n_devices that divides n_workers --
    the worker axis size :func:`worker_mesh` uses."""
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    return max(d for d in range(1, min(n_workers, max(n_devices, 1)) + 1)
               if n_workers % d == 0)


@dataclass(frozen=True)
class WorkerMesh:
    """The W workers of a strategy laid out on the ranks.

    ``n`` ranks hold ``W / n`` lanes each, worker ``i`` on rank
    ``i // (W / n)``; ``lanes`` are this rank's global worker indices
    (empty on a rank past the axis).  ``group`` is the collectives'
    process group: None on the one-rank mesh of a single process, where
    every collective is the identity and none runs.
    """

    n_workers: int
    n: int
    world: int
    rank: int
    lanes: Tuple[int, ...]
    device: Optional[str] = None
    group: Any = None
    axis: str = "data"

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def all_reduce(self, t):
        """``t`` summed over the ranks in place (the identity without a
        group); returns ``t``."""
        if self.group is not None:
            import torch.distributed as dist
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t


def check_mesh(what: str, mesh, n_workers: Optional[int] = None
               ) -> WorkerMesh:
    """``mesh`` if it is a :class:`WorkerMesh` (of ``n_workers``
    workers, when given); ``what`` names the caller in the error."""
    if not isinstance(mesh, WorkerMesh):
        raise TypeError(f"{what}: want a runtime.cluster.WorkerMesh "
                        f"(worker_mesh(W)), got {mesh!r}")
    if n_workers is not None and mesh.n_workers != n_workers:
        raise ValueError(f"{what}: the mesh lays out {mesh.n_workers} "
                         f"workers, the config {n_workers}")
    return mesh


def worker_mesh(n_workers: int, *, axis: str = "data") -> WorkerMesh:
    """The worker-axis mesh for a W-worker strategy.

    Axis size = the widest divisor of W the ranks admit: each of the
    first ``n`` ranks then carries W/n lanes (all of them on one rank at
    laptop scale; one each on the paper's 16-GPU shape); a rank past the
    axis carries none.  Without :func:`initialize` (or after a no-op
    one) this is the one-rank mesh holding every lane.
    """
    info = _ACTIVE
    if info is None or not info.initialized:
        widest_divisor(n_workers, 1)           # W >= 1
        return WorkerMesh(n_workers=n_workers, n=1, world=1, rank=0,
                          lanes=tuple(range(n_workers)), axis=axis)
    import torch.distributed as dist
    n = widest_divisor(n_workers, info.process_count)
    per = n_workers // n
    rank = info.process_index
    lanes = tuple(range(rank * per, (rank + 1) * per)) if rank < n else ()
    return WorkerMesh(n_workers=n_workers, n=n, world=info.process_count,
                      rank=rank, lanes=lanes, device=info.device,
                      group=dist.group.WORLD, axis=axis)


# The paper's deployment shapes (§3.4-3.5): name -> worker count.
PAPER_TOPOLOGIES = {
    "bmuf-64": 64,       # SSL CE stage: BMUF across 64 GPUs
    "gtc-16": 16,        # sMBR sequence training: GTC across 16 GPUs
}


def topology_mesh(name: str, *, axis: str = "data") -> WorkerMesh:
    """worker_mesh for a named paper topology (``bmuf-64``/``gtc-16``)."""
    if name not in PAPER_TOPOLOGIES:
        raise KeyError(f"unknown topology {name!r}; "
                       f"have {sorted(PAPER_TOPOLOGIES)}")
    return worker_mesh(PAPER_TOPOLOGIES[name], axis=axis)
