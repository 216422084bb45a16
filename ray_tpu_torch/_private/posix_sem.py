"""POSIX named semaphores via ctypes (no extra deps).

The channel layer needs cross-process blocking rendezvous between
unrelated processes (driver ↔ actors). Python's multiprocessing
semaphores only work across fork; named semaphores (sem_open) work by
name, like the reference's plasma fd-passing + futex-based mutable
object channels.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import time
from typing import Optional

_libpthread = ctypes.CDLL(
    ctypes.util.find_library("pthread") or "libpthread.so.0",
    use_errno=True,
)

_sem_open = _libpthread.sem_open
_sem_open.restype = ctypes.c_void_p
_sem_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_uint, ctypes.c_uint]
_sem_wait = _libpthread.sem_wait
_sem_wait.argtypes = [ctypes.c_void_p]
_sem_trywait = _libpthread.sem_trywait
_sem_trywait.argtypes = [ctypes.c_void_p]
_sem_timedwait = _libpthread.sem_timedwait
_sem_post = _libpthread.sem_post
_sem_post.argtypes = [ctypes.c_void_p]
_sem_close = _libpthread.sem_close
_sem_close.argtypes = [ctypes.c_void_p]
_sem_unlink = _libpthread.sem_unlink
_sem_unlink.argtypes = [ctypes.c_char_p]

_O_CREAT = os.O_CREAT
SEM_FAILED = ctypes.c_void_p(0).value


class _timespec(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_nsec", ctypes.c_long)]


_sem_timedwait.argtypes = [ctypes.c_void_p, ctypes.POINTER(_timespec)]


class NamedSemaphore:
    def __init__(self, name: str, create: bool = False, initial: int = 0):
        if not name.startswith("/"):
            name = "/" + name
        self.name = name
        flags = _O_CREAT if create else 0
        handle = _sem_open(name.encode(), flags, 0o600, initial)
        if handle in (None, SEM_FAILED):
            raise OSError(ctypes.get_errno(), f"sem_open failed for {name}")
        self._h = handle

    def post(self) -> None:
        if _sem_post(self._h) != 0:
            raise OSError(ctypes.get_errno(), "sem_post failed")

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until acquired; False on timeout."""
        if timeout is None:
            while True:
                if _sem_wait(self._h) == 0:
                    return True
                if ctypes.get_errno() != errno.EINTR:
                    raise OSError(ctypes.get_errno(), "sem_wait failed")
        deadline = time.time() + timeout
        ts = _timespec(int(deadline), int((deadline % 1) * 1e9))
        while True:
            if _sem_timedwait(self._h, ctypes.byref(ts)) == 0:
                return True
            e = ctypes.get_errno()
            if e == errno.ETIMEDOUT:
                return False
            if e != errno.EINTR:
                raise OSError(e, "sem_timedwait failed")

    def trywait(self) -> bool:
        if _sem_trywait(self._h) == 0:
            return True
        e = ctypes.get_errno()
        if e in (errno.EAGAIN, errno.EINTR):
            return False
        raise OSError(e, "sem_trywait failed")

    def close(self) -> None:
        if self._h is not None:
            _sem_close(self._h)
            self._h = None

    def unlink(self) -> None:
        _sem_unlink(self.name.encode())
