"""Process-level primitives shared by the work ledger and the store.

The port's copy of the reference's ``runtime/procs.py`` (standard
library only), under the same names:

* :func:`file_lock` — an ``fcntl.flock`` advisory lock scoped to a
  ``with`` block.  Every cross-process read-modify-write of a shared
  JSON file (ledger claims, manifest commits) serializes through one of
  these; the lock file lives next to the data file so any process on
  the shared filesystem contends on the same inode.
* :class:`Heartbeat` — a daemon thread touching ``<dir>/<owner>.hb``
  every ``interval_s``.  Liveness is the file's mtime: a supervisor (or
  a rival worker) reads :func:`heartbeat_age` and steals claims whose
  owner has gone quiet — the *hung*-worker case reopen-time demotion
  can never catch, because a hung process never reopens anything.
* :class:`CrashPoint` — deterministic fault injection: ``SIGKILL`` the
  calling process after its N-th ``tick()``.  A real kill (not an
  exception), so the death leaves exactly what a machine failure
  leaves: a claimed ledger entry, a stale heartbeat, possibly a
  staged-but-uncommitted shard.  Never arm it in a process whose death
  ends more than the worker (a test runner, a smoke script).

* :func:`repro_pythonpath` / :func:`child_env` — the environment a
  spawned worker interpreter starts from: ``PYTHONPATH`` leads with the
  directory that holds ``repro_torch``, so the child imports the code
  the parent runs.
"""
from __future__ import annotations

import os
import signal
import threading
import time
from contextlib import contextmanager
from typing import Iterator, Optional

try:
    import fcntl
    _HAVE_FCNTL = True
except ImportError:                       # non-POSIX: single-process only
    _HAVE_FCNTL = False


@contextmanager
def file_lock(path: str, *, timeout_s: float = 30.0,
              poll_s: float = 0.01) -> Iterator[None]:
    """Exclusive advisory lock on `path` (created if missing).

    Blocks up to ``timeout_s`` (then raises TimeoutError) rather than
    forever: a worker must never deadlock the fleet on a lock whose
    holder died mid-critical-section — flock releases on process death,
    so the timeout only trips on genuine livelock or an NFS mount
    without lock support.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        if _HAVE_FCNTL:
            deadline = time.monotonic() + timeout_s
            while True:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"file_lock({path}): not acquired within "
                            f"{timeout_s}s")
                    time.sleep(poll_s)
        yield
    finally:
        if _HAVE_FCNTL:
            fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


# ------------------------------------------------------------ heartbeats

def heartbeat_path(hb_dir: str, owner: str) -> str:
    return os.path.join(hb_dir, f"{owner}.hb")


def beat(hb_dir: str, owner: str) -> str:
    """Touch the owner's heartbeat file once; returns its path."""
    os.makedirs(hb_dir, exist_ok=True)
    path = heartbeat_path(hb_dir, owner)
    with open(path, "a"):
        os.utime(path, None)
    return path


def heartbeat_age(hb_dir: str, owner: str, *,
                  now: Optional[float] = None) -> Optional[float]:
    """Seconds since the owner's last beat; None if it never beat
    (treat as infinitely stale — a worker that died before its first
    beat must still be stealable)."""
    try:
        mtime = os.path.getmtime(heartbeat_path(hb_dir, owner))
    except OSError:
        return None
    return (time.time() if now is None else now) - mtime


class Heartbeat:
    """Daemon thread beating ``<dir>/<owner>.hb`` every ``interval_s``.

    Used as a context manager inside worker processes; `stop()` is
    idempotent.  The first beat happens synchronously in start() so a
    claim made immediately after is never older than its heartbeat.
    """

    def __init__(self, hb_dir: str, owner: str, *,
                 interval_s: float = 0.25):
        self.hb_dir = hb_dir
        self.owner = owner
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Heartbeat":
        beat(self.hb_dir, self.owner)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"hb-{self.owner}")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                beat(self.hb_dir, self.owner)
            except OSError:               # dir swept mid-shutdown: benign
                return

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# -------------------------------------------------------- fault injection

class CrashPoint:
    """Deterministic SIGKILL-after-N-ticks fault injector.

    ``CrashPoint(after=2)``: the 3rd ``tick()`` kills the process with
    SIGKILL — uncatchable, mid-whatever-it-was-doing, exactly like the
    fleet losing a machine.  ``after=None`` never fires (the production
    default).
    """

    def __init__(self, after: Optional[int] = None):
        self.after = after
        self.ticks = 0

    def tick(self):
        self.ticks += 1
        if self.after is not None and self.ticks > self.after:
            os.kill(os.getpid(), signal.SIGKILL)


# ------------------------------------------------------------- spawning

def repro_pythonpath() -> str:
    """A PYTHONPATH under which a child can ``import repro_torch``: the
    directory holding the package, prepended to any existing setting so
    children resolve the same code the parent runs."""
    import repro_torch
    pkg_parent = os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__)))
    existing = os.environ.get("PYTHONPATH", "")
    if existing and pkg_parent not in existing.split(os.pathsep):
        return pkg_parent + os.pathsep + existing
    return existing or pkg_parent


def child_env(extra: Optional[dict] = None) -> dict:
    """The environment for a spawned worker: inherit, fix PYTHONPATH,
    apply overrides."""
    env = dict(os.environ)
    env["PYTHONPATH"] = repro_pythonpath()
    if extra:
        env.update(extra)
    return env
