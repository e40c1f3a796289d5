"""A cooperative lock on the card (counterpart of ``myriad_tpu/common/tpu_lock.py``).

Two jobs that share one card time-slice it, and each one's measurement reads
the other's work.  Entry points that measure on the card hold this advisory
lockfile for their run (``python -m myriad_tpu_torch.evaluate`` on the card):

* ``acquire`` writes its record to a file of its own and hard-links it to
  the lockfile's name, which fails when the name exists: of two acquirers
  that race exactly one creates it, and the lockfile is never seen without
  its record (a holder descheduled between creating an empty file and
  writing it could lose the lock to a second acquirer).  A record whose pid
  is dead, whose deadline has passed, or that cannot be read is unlinked
  (under a guard file's ``flock``, the record read again there) and the
  create is tried again.
* A holder past its deadline whose pid is still alive is reported on stderr
  (pid and tag) before its lock is reclaimed, so a measurement window it
  shared is on record.
* The holder's subprocesses re-enter through the token in
  ``MYRIAD_CARD_LOCK_TOKEN``, which ``acquire`` sets in the environment.

The lockfile is ``.runs/card.lock`` under the repository, or
``MYRIAD_CARD_LOCK``.
"""

from __future__ import annotations

import contextlib
import errno
import fcntl
import json
import os
import sys
import time
from typing import Optional

ENV_TOKEN = "MYRIAD_CARD_LOCK_TOKEN"
ENV_PATH = "MYRIAD_CARD_LOCK"


def lock_path() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.environ.get(ENV_PATH) or os.path.join(repo, ".runs", "card.lock")


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except OSError as e:
        return e.errno == errno.EPERM
    return True


def holder(path: Optional[str] = None) -> Optional[dict]:
    """The live holder's record, or None (no file, an unreadable one, a dead
    pid or a passed deadline)."""
    rec = _read(path or lock_path())
    if rec is None or time.time() > float(rec.get("deadline", 0)):
        return None
    return rec if _pid_alive(int(rec.get("pid", -1))) else None


def _parse(data: str) -> Optional[dict]:
    try:
        rec = json.loads(data)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) else None


def _read(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return _parse(f.read())
    except OSError:
        return None


@contextlib.contextmanager
def _guard(path: str):
    """Turns among the processes that unlink the lockfile (reclaimers and the
    holder's release): each opens the record and unlinks it under the guard
    file's ``flock``.  A create never replaces a file, so the file a turn
    unlinks is the one it read, never a record another acquirer has just
    created."""
    with open(path + ".guard", "a") as guard:
        fcntl.flock(guard, fcntl.LOCK_EX)
        yield


def _reclaim(path: str) -> bool:
    """Unlink a stale record (reporting a live holder past its deadline);
    True when the lockfile is gone, False when it belongs to a live holder
    within its deadline.  A lockfile appears with its record whole
    (``_create``), so one that cannot be read is stale."""
    with _guard(path):
        try:
            with open(path) as f:
                data = f.read()
        except FileNotFoundError:
            return True  # gone already: create again, unlink nothing
        rec = _parse(data)
        if rec is not None:
            pid = int(rec.get("pid", -1))
            alive = _pid_alive(pid)
            if alive and time.time() <= float(rec.get("deadline", 0)):
                return False
            if alive:
                print(f"[card_lock] pid {pid} ({rec.get('tag')}) holds the card past its "
                      f"deadline ({time.ctime(float(rec.get('deadline', 0)))}); reclaiming "
                      "the lock while it still runs: measurements of both may be "
                      "contaminated", file=sys.stderr)
        os.unlink(path)
        return True


def _create(path: str, tag: str, max_hold_s: float) -> Optional[str]:
    """Create the lockfile with our record, whole from its first instant (a
    hard link to the record written beside it); the token, or None if it
    exists."""
    now = time.time()
    token = f"{os.getpid()}-{time.time_ns()}"
    rec = {"pid": os.getpid(), "tag": tag, "t0": now, "deadline": now + max_hold_s,
           "token": token}
    tmp = f"{path}.{token}"
    with open(tmp, "w") as f:
        json.dump(rec, f)
    try:
        os.link(tmp, path)
    except FileExistsError:
        return None
    finally:
        os.unlink(tmp)
    return token


def acquire(tag: str, max_hold_s: float = 7200.0, wait_s: float = 0.0,
            poll_s: float = 1.0) -> bool:
    """Take the lock, waiting up to ``wait_s`` for a live holder.  True when
    taken (or re-entered through an inherited token), False when the wait
    ran out with the lock still held."""
    path = lock_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    inherited = os.environ.get(ENV_TOKEN)
    if inherited:
        rec = _read(path)
        if rec is not None and rec.get("token") == inherited:
            return True
    t_end = time.time() + wait_s
    while True:
        token = _create(path, tag, max_hold_s)
        if token is not None:
            os.environ[ENV_TOKEN] = token
            return True
        if _reclaim(path):
            continue
        if time.time() >= t_end:
            cur = _read(path) or {}
            print(f"[card_lock] busy: held by pid {cur.get('pid')} ({cur.get('tag')}) since "
                  f"{time.ctime(float(cur.get('t0', 0)))}", file=sys.stderr)
            return False
        time.sleep(min(poll_s, max(t_end - time.time(), 0.0)))


def release() -> None:
    """Unlink the lockfile if this process holds it."""
    path = lock_path()
    token = os.environ.pop(ENV_TOKEN, None)
    if not token or not os.path.exists(path):
        return
    with _guard(path):
        rec = _read(path)
        if rec is not None and rec.get("token") == token and rec.get("pid") == os.getpid():
            with contextlib.suppress(OSError):
                os.unlink(path)


@contextlib.contextmanager
def card_lock(tag: str, max_hold_s: float = 7200.0, wait_s: float = 1800.0,
              required: bool = False):
    """Hold the card for the block.  When the wait runs out, ``required``
    raises; otherwise the block runs without the lock, after a warning on
    stderr."""
    got = acquire(tag, max_hold_s=max_hold_s, wait_s=wait_s)
    if not got:
        if required:
            raise RuntimeError(f"the card lock is held elsewhere; '{tag}' did not get it")
        print(f"[card_lock] proceeding without the lock ({tag}): another job may "
              "contaminate this measurement", file=sys.stderr)
    try:
        yield got
    finally:
        if got:
            release()
