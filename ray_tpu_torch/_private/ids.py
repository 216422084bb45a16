"""Unique identifiers for objects, tasks, actors, workers, nodes, placement groups.

A rebuild of the reference's ID scheme (reference:
src/ray/common/id.h, design doc src/ray/design_docs/id_specification.md).
The reference derives ObjectIDs from TaskID + return index; we keep that
property (deterministic return ids) but use flat 16-byte random ids
elsewhere — the lineage-addressing tricks of the reference are carried in
metadata instead of bit-packed id layouts.
"""
from __future__ import annotations

import itertools
import os
import struct
import binascii

ID_LENGTH = 16  # bytes

# Per-process unique id generation without a syscall per id: an 8-byte
# random process prefix + a little-endian 8-byte counter. The LOW 4
# counter bytes land in id[8:12], so the first 12 bytes (the prefix a
# return-ObjectID shares with its TaskID — bytes_for_return) stay
# unique for 2^32 ids per process. urandom(16) costs ~5us per call,
# which is real money on the steady-state submit path.
_uniq_prefix = os.urandom(8)
_uniq_count = itertools.count(1)
_pack_q = struct.Struct("<Q").pack


def _reseed_after_fork() -> None:
    """Forked children (zygote fast-spawn path) MUST NOT inherit the
    prefix+counter: two forked workers would mint identical ids."""
    global _uniq_prefix, _uniq_count
    _uniq_prefix = os.urandom(8)
    _uniq_count = itertools.count(1)


os.register_at_fork(after_in_child=_reseed_after_fork)


def fast_unique_bytes() -> bytes:
    return _uniq_prefix + _pack_q(next(_uniq_count))


class BaseID:
    __slots__ = ("_bytes",)
    _type_salt = 0

    def __init__(self, id_bytes: bytes):
        if not isinstance(id_bytes, bytes) or len(id_bytes) != ID_LENGTH:
            raise ValueError(f"{type(self).__name__} requires {ID_LENGTH} bytes")
        self._bytes = id_bytes

    @classmethod
    def from_random(cls):
        return cls(os.urandom(ID_LENGTH))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(binascii.unhexlify(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * ID_LENGTH)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * ID_LENGTH

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return binascii.hexlify(self._bytes).decode()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._type_salt = hash(cls.__name__)

    def __hash__(self):
        # No tuple allocation: id hashing shows up in every set/dict of
        # refs on the hot path.
        return hash(self._bytes) ^ self._type_salt

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class ObjectID(BaseID):
    @classmethod
    def for_task_return(cls, task_id: "TaskID", index: int) -> "ObjectID":
        # Deterministic: 12 random bytes of the task id + the return
        # index (the reference packs the index into the id the same way
        # — id.h ObjectID::ForTaskReturn). Runs on the submit hot path,
        # so no hashing: task ids are random, 96 bits of prefix is
        # collision-proof at any realistic task count.
        oid = cls.__new__(cls)
        oid._bytes = task_id._bytes[:12] + index.to_bytes(4, "little")
        return oid

    @staticmethod
    def bytes_for_return(task_id_bytes: bytes, index: int) -> bytes:
        """Raw-bytes variant for wire-frame paths that skip ID objects."""
        return task_id_bytes[:12] + index.to_bytes(4, "little")


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class WorkerID(BaseID):
    pass


class NodeID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class JobID(BaseID):
    pass
