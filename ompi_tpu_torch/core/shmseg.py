"""Shared-memory segments — generic named create/attach framework (the
port's copy of the JAX package's ``core/shmseg.py``, whole).

≈ opal/mca/shmem (mmap/posix/sysv components): the one place that knows
how to create, publish, attach, and clean up shared segments; consumers
(the shm BTL's rings, any future shared cache) layer their protocols on
top instead of each reinventing tmpfile+mmap+rendezvous.

Design (mirrors the mmap component, the one the reference prefers):
- a segment is a file in /dev/shm (tmpfs) — or TMPDIR when absent —
  created atomically (tempfile + rename) so attachers never observe a
  half-initialized segment;
- the creator maps it read-write and owns unlink; attachers map an
  existing path (the mapping survives unlink — crash cleanup is free);
- a small magic+size header guards against attaching garbage.
"""

from __future__ import annotations

import mmap
import os
import struct
import tempfile
from typing import Optional

__all__ = ["SharedSegment", "create", "attach", "attach_retry",
           "backing_dir"]

_MAGIC = 0x53454731            # "SEG1"
_HDR = 16                      # magic u32 | pad u32 | size u64


def backing_dir() -> str:
    """tmpfs when the platform offers it (zero-copy page cache), TMPDIR
    otherwise — the mmap-component fallback order."""
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


class SharedSegment:
    """One mapped segment; ``buf`` is the usable memoryview (header
    excluded)."""

    def __init__(self, path: str, mm: mmap.mmap, size: int,
                 creator: bool) -> None:
        self.path = path
        self.size = size
        self.creator = creator
        self._mm = mm
        self._tmp: Optional[str] = None   # set for unpublished segments
        self.buf = memoryview(mm)[_HDR:_HDR + size]

    def publish(self) -> None:
        """Rename an unpublished segment into place (after the consumer
        initialized its own header in ``buf``)."""
        if self._tmp is not None:
            os.rename(self._tmp, self.path)
            self._tmp = None

    def detach(self) -> None:
        try:
            self.buf.release()
            self._mm.close()
        except (BufferError, ValueError):
            pass

    def unlink(self) -> None:
        """Remove the name (creator's job); live mappings stay valid.
        An unpublished segment removes its temp file instead."""
        try:
            os.unlink(self._tmp or self.path)
        except OSError:
            pass
        self._tmp = None

    def close(self) -> None:
        if self.creator:
            self.unlink()
        self.detach()

    def __enter__(self) -> "SharedSegment":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def create(name: str, size: int, dir: Optional[str] = None,
           publish: bool = True) -> SharedSegment:
    """Create a named segment; with ``publish=True`` (default) it is
    renamed into place immediately (atomic: an attacher either sees the
    full initialized segment or nothing).

    A consumer that writes ITS OWN protocol header into ``buf`` before
    attachers may look (the shm BTL ring does) passes ``publish=False``,
    initializes, then calls :meth:`SharedSegment.publish` — keeping the
    never-see-half-initialized invariant for the layered protocol too.
    """
    base = dir or backing_dir()
    fd, tmp = tempfile.mkstemp(prefix=".seg-", dir=base)
    try:
        os.ftruncate(fd, _HDR + size)
        mm = mmap.mmap(fd, _HDR + size)
    finally:
        os.close(fd)
    struct.pack_into("<IIQ", mm, 0, _MAGIC, 0, size)
    path = os.path.join(base, name)
    seg = SharedSegment(path, mm, size, creator=True)
    if publish:
        os.rename(tmp, path)
    else:
        seg._tmp = tmp
    return seg


def attach_retry(path: str, timeout: float = 5.0,
                 interval: float = 0.001) -> SharedSegment:
    """Attach, waiting out the creator's publish window: a consumer that
    learned ``path`` out-of-band (a business card, a bootstrap bcast)
    may look before the atomic rename lands.  Bounded poll, then the
    last OSError propagates."""
    import time

    deadline = time.monotonic() + timeout
    while True:
        try:
            return attach(path)
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(interval)


def attach(path: str) -> SharedSegment:
    """Attach an existing segment; raises OSError on garbage/missing."""
    fd = os.open(path, os.O_RDWR)
    try:
        total = os.fstat(fd).st_size
        mm = mmap.mmap(fd, total)
    finally:
        os.close(fd)
    magic, _, size = struct.unpack_from("<IIQ", mm, 0)
    if magic != _MAGIC or _HDR + size > total:
        mm.close()
        raise OSError(f"{path}: not a valid shared segment")
    return SharedSegment(path, mm, size, creator=False)
