"""Value serialization for the object store and control plane.

The reference uses a msgpack + pickle5 protocol with out-of-band buffers
(reference: python/ray/_private/serialization.py) so large numpy / arrow
buffers travel zero-copy through plasma. We keep the same shape: values
are cloudpickle-serialized with pickle protocol 5, out-of-band buffers are
concatenated after a small header so a reader can reconstruct them as
memoryviews over shared memory without copying.

Layout of a serialized value:

    [8s magic][u32 pickle_len][u32 nbuffers][u64 buffer_len]*n
    [pickle bytes][buffer bytes]*n  (each buffer 64-byte aligned)

torch tensors travel as one out-of-band buffer each: the in-band pickle
holds only the dtype, shape and grad flag, and the bytes go through shared
memory. A CUDA tensor is first copied to the host by the pickler, wherever
it lies in the value (the reference converts a top-level jax.Array to
numpy in `prepare_value`, which the port does not need); `get` returns a
CPU tensor with the same dtype, shape and bits, which the consumer moves
to its own card.

A tensor is never a view over the object's shared memory: torch has no
read-only tensor, so a reader could write into a sealed object through
it. Unpacking copies each tensor's bytes once out of the mapping. numpy
arrays keep the reference's zero-copy views.
"""
from __future__ import annotations

import io
import pickle
import struct
import sys
from typing import Any, List, Tuple

import cloudpickle

MAGIC = b"RTPUOBJ1"
_ALIGN = 64


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


# Types plain pickle round-trips identically to cloudpickle (no code
# objects, no __main__-defined classes to ship by value). Plain pickle
# is ~7x faster on these, and they dominate hot-path payloads.
_PLAIN_TYPES = frozenset(
    (bytes, bytearray, str, int, float, bool, type(None))
)


def dumps(value: Any) -> Tuple[bytes, List[pickle.PickleBuffer]]:
    """Serialize to (header+pickle bytes, out-of-band buffers)."""
    buffers: List[pickle.PickleBuffer] = []
    t = type(value)
    if t in _PLAIN_TYPES or (
        t.__module__ == "numpy" and t.__name__ == "ndarray"
        and value.dtype.hasobject is False
    ):
        payload = pickle.dumps(value, 5, buffer_callback=buffers.append)
    else:
        with io.BytesIO() as f:
            _Pickler(f, protocol=5, buffer_callback=buffers.append).dump(value)
            payload = f.getvalue()
    return payload, buffers


class _Pickler(cloudpickle.Pickler):
    """cloudpickle with torch tensors reduced to one out-of-band buffer.

    A pickler-local reducer, not a copyreg entry: a process-wide one would
    change how `torch.save` and every other pickler sees tensors."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")  # no torch loaded: no tensors
        if torch is not None and type(obj) in (torch.Tensor, torch.nn.Parameter):
            reduced = _reduce_tensor(torch, obj)
            if reduced is not None:
                return reduced
        return super().reducer_override(obj)


def _reduce_tensor(torch, t):
    """(rebuild, args) for a dense tensor; None for the layouts torch's
    own pickling must handle (sparse, quantized, meta)."""
    if t.layout != torch.strided or t.is_quantized or t.is_meta:
        return None
    host = t.detach()
    if host.device.type != "cpu":
        # device -> host: the reference's prepare_value for jax.Array
        host = host.cpu()
    host = host.resolve_conj().resolve_neg().contiguous()
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return _rebuild_tensor, (
        pickle.PickleBuffer(raw), str(t.dtype).rsplit(".", 1)[-1],
        tuple(t.shape), t.requires_grad, type(t) is torch.nn.Parameter,
    )


def _rebuild_tensor(buf, dtype: str, shape, requires_grad: bool,
                    parameter: bool):
    """A CPU tensor from its bytes, copied once out of `buf` (which may be
    a read-only view of a sealed object's shared memory). The bytes travel
    as uint8, since numpy has no bfloat16; `.view` restores the dtype."""
    import numpy as np
    import torch

    data = np.frombuffer(buf, dtype=np.uint8).copy()
    if data.size:
        t = torch.from_numpy(data).view(getattr(torch, dtype)).reshape(shape)
    else:
        t = torch.empty(shape, dtype=getattr(torch, dtype))
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad)


def serialized_size(payload: bytes, buffers: List[pickle.PickleBuffer]) -> int:
    header = 8 + 4 + 4 + 8 * len(buffers)
    size = _align(header + len(payload))
    for b in buffers:
        size += _align(len(b.raw()))
    return size


def write_to(view: memoryview, payload: bytes, buffers: List[pickle.PickleBuffer]) -> int:
    """Write the serialized value into a writable memoryview; returns bytes used."""
    header = struct.pack(
        f"<8sII{len(buffers)}Q",
        MAGIC,
        len(payload),
        len(buffers),
        *[len(b.raw()) for b in buffers],
    )
    off = 0
    view[off : off + len(header)] = header
    off += len(header)
    view[off : off + len(payload)] = payload
    off = _align(off + len(payload))
    for b in buffers:
        raw = b.raw()
        n = len(raw)
        view[off : off + n] = raw
        off = _align(off + n)
    return off


def pack(value: Any) -> bytes:
    """Serialize into one contiguous bytes object (for inline objects)."""
    payload, buffers = dumps(value)
    size = serialized_size(payload, buffers)
    buf = bytearray(size)
    write_to(memoryview(buf), payload, buffers)
    return bytes(buf)


def unpack(view: memoryview | bytes) -> Any:
    """Deserialize from a buffer produced by write_to/pack.

    Out-of-band buffers are reconstructed as zero-copy memoryviews into
    ``view`` — keep the backing shared memory mapped while the value lives.
    """
    view = memoryview(view)
    magic, pickle_len, nbuf = struct.unpack_from("<8sII", view, 0)
    if magic != MAGIC:
        raise ValueError("corrupt serialized object (bad magic)")
    off = 16
    buf_lens = struct.unpack_from(f"<{nbuf}Q", view, off)
    off += 8 * nbuf
    payload = view[off : off + pickle_len]
    off = _align(off + pickle_len)
    buffers = []
    for n in buf_lens:
        buffers.append(view[off : off + n])
        off = _align(off + n)
    return pickle.loads(payload, buffers=buffers)


def total_size(view: memoryview | bytes) -> int:
    """Exact serialized size of a value from its header (segments are
    page-rounded, so the mapping may be larger than the object)."""
    view = memoryview(view)
    magic, pickle_len, nbuf = struct.unpack_from("<8sII", view, 0)
    if magic != MAGIC:
        raise ValueError("corrupt serialized object (bad magic)")
    buf_lens = struct.unpack_from(f"<{nbuf}Q", view, 16)
    size = _align(16 + 8 * nbuf + pickle_len)
    for n in buf_lens:
        size += _align(n)
    return size
