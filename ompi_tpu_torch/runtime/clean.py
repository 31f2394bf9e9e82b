"""Stale-artifact cleanup — the orte-clean equivalent (the port's copy of
the JAX package's ``runtime/clean.py``, whole).

≈ orte/tools/orte-clean (orte-clean.c): crashed or killed jobs leave
debris behind — here that is shared-memory inbox directories and ring
files (btl/shm), shared-file-pointer and shared-window segments
(sharedfp/sm, osc SharedWindow), orphaned ``.seg-*`` temp files from
interrupted segment creation, and a dead DVM's uri file.  ``tpurun
--clean`` sweeps everything owned by the current user whose owning
process is provably gone (or, with ``age>0``, anything older than the
given seconds — the reference's "no jobs of mine are running" big
hammer).

Liveness: an inbox dir name carries no pid, but the doorbell FIFO inside
it has an OPEN reader exactly while its rank lives — a zero-reader FIFO
(nonblocking write raises ENXIO) marks the whole inbox dead.  A rank
makes its FIFO before it opens the read end, so an inbox changed within
the last ``_INBOX_GRACE_S`` seconds is never judged: a rank still
starting up is not swept (the port's rule; the JAX package judges every
inbox at once).  Segment files have no such signal and fall back to the
age threshold.
"""

from __future__ import annotations

import errno
import os
import shutil
import tempfile
import time
from typing import Optional

from ompi_tpu_torch.core import output

__all__ = ["clean", "scan", "default_uri_path"]

_log = output.get_stream("clean")

#: /dev/shm (or TMPDIR) name prefixes this framework creates
_PREFIXES = ("otpu-shm-", "otpu-shfp-", "otpu-shwin-", ".seg-")

#: seconds after its last change that an inbox is left unjudged
_INBOX_GRACE_S = 5.0


def _dirs() -> list[str]:
    out = []
    if os.path.isdir("/dev/shm"):
        out.append("/dev/shm")
    td = tempfile.gettempdir()
    if td not in out:
        out.append(td)
    return out


def _inbox_alive(path: str) -> bool:
    """A live btl/shm inbox has its owning rank blocked on (or at least
    holding) the doorbell FIFO's read end; opening the write end
    nonblocking fails with ENXIO when no reader exists."""
    db = os.path.join(path, "doorbell")
    try:
        fd = os.open(db, os.O_WRONLY | os.O_NONBLOCK)
    except OSError as e:
        return e.errno != errno.ENXIO   # ENOENT/EACCES: can't prove dead
    os.close(fd)
    return True


def _mapped_paths() -> Optional[set]:
    """ONE pass over /proc/*/maps collecting every mapped path that
    carries our prefixes — the precise liveness signal for mmap-backed
    artifacts (their mtime never advances after creation, so age alone
    would hit live windows).  None ⇒ procfs unreadable: prove nothing,
    keep everything."""
    try:
        pids = [n for n in os.listdir("/proc") if n.isdigit()]
    except OSError:
        return None
    mapped: set = set()
    for pid in pids:
        try:
            with open(f"/proc/{pid}/maps", encoding="utf-8",
                      errors="replace") as f:
                for line in f:
                    if "otpu-" not in line and "/.seg-" not in line:
                        continue
                    # path starts at the 6th field; spaces in our names
                    # never occur (prefix + hex)
                    idx = line.find("/")
                    if idx >= 0:
                        mapped.add(line[idx:].rstrip("\n")
                                   .removesuffix(" (deleted)"))
        except OSError:
            continue   # other-uid / vanished process
    return mapped


def default_uri_path() -> str:
    """The per-user file a standing DVM writes its control URI to when no
    ``--dvm-uri`` is given (the JAX package's ``dvm.default_uri_path``,
    the same file; ``runtime/dvm.py`` serves it from here)."""
    return os.path.join(
        os.environ.get("TMPDIR", "/tmp"),
        f"ompi_tpu-dvm-{os.getuid()}.uri")


def _dead_dvm_uri() -> Optional[str]:
    """Path of a uri file whose LOCAL HNP provably refused the
    connection (port closed ⇒ dead), else None.  An unreachable or slow
    HNP is NOT death — sweeping it would orphan a live daemon tree."""
    import socket

    uri_path = default_uri_path()
    if not os.path.exists(uri_path):
        return None
    try:
        with open(uri_path, encoding="utf-8") as f:
            target = f.read().strip()
        host, port = target.rsplit(":", 1)
    except (OSError, ValueError):
        return uri_path   # unreadable/garbled uri file IS debris
    if host not in ("127.0.0.1", "localhost", "::1",
                    os.uname().nodename):
        return None       # cannot judge a remote HNP from here
    try:
        conn = socket.create_connection((host, int(port)), timeout=2)
        conn.close()
        return None       # something listens: leave it alone
    except ConnectionRefusedError:
        return uri_path   # positive death: nothing on the port
    except OSError:
        return None       # timeout/route problems prove nothing


def scan(age: float = 0.0) -> list[tuple[str, str]]:
    """→ [(path, reason)] of artifacts that WOULD be removed."""
    me = os.getuid()
    now = time.time()
    victims: list[tuple[str, str]] = []
    mapped: Optional[set] = ()   # lazily computed on first segment
    for base in _dirs():
        try:
            names = os.listdir(base)
        except OSError:
            continue
        for name in names:
            if not any(name.startswith(p) for p in _PREFIXES):
                continue
            path = os.path.join(base, name)
            try:
                st = os.lstat(path)
            except OSError:
                continue
            if st.st_uid != me:
                continue            # never touch other users' jobs
            if age > 0:
                if now - st.st_mtime > age:
                    victims.append((path, f"older than {age:.0f}s"))
                continue
            if name.startswith("otpu-shm-") and os.path.isdir(path):
                if (now - st.st_mtime > _INBOX_GRACE_S
                        and not _inbox_alive(path)):
                    victims.append((path, "no doorbell reader (rank gone)"))
            else:
                # mmap-backed segments: mtime never advances after
                # creation, so "old" ≠ "idle" — only sweep when no live
                # process maps the file (plus a short grace for the
                # create→mmap window).  The /proc sweep runs ONCE for
                # the whole scan, not per candidate.
                if now - st.st_mtime <= 60:
                    continue
                if mapped == ():
                    mapped = _mapped_paths()
                if mapped is not None and path not in mapped:
                    victims.append((path, "segment mapped by no process"))
    dead_uri = _dead_dvm_uri()
    if dead_uri is not None:
        victims.append((dead_uri, "DVM uri, local port refused"))
    return victims


def clean(age: float = 0.0, dry_run: bool = False,
          report=None) -> list[str]:
    """Remove stale artifacts; returns the removed paths.

    ``age``: 0 = liveness-based (safe while jobs run); >0 = also remove
    anything older than this many seconds (use when no jobs are active,
    the orte-clean stance).  ``report``: callable(line) for progress
    (tpurun passes print).  ``dry_run``: returns the would-remove paths
    without touching anything.
    """
    removed = []
    failed = []
    for path, reason in scan(age):
        if report:
            report(f"{'would remove' if dry_run else 'removing'} "
                   f"{path}  ({reason})")
        if dry_run:
            removed.append(path)
            continue
        try:
            if os.path.isdir(path):
                shutil.rmtree(path)   # errors surface: a path we could
            else:                     # not remove must not be reported
                os.unlink(path)       # as cleaned
            removed.append(path)
        except OSError as e:
            failed.append(path)
            msg = f"could NOT remove {path}: {e}"
            if report:
                report(msg)           # visible, not verbose-only: the
            _log.error("clean: %s", msg)   # caller believes it cleaned
    if failed and not dry_run:
        raise OSError(f"{len(failed)} artifact(s) could not be removed "
                      f"(removed {len(removed)}): {failed[:3]}")
    return removed
