"""The port's native control-plane hot path (the port's own
`_private/csrc/fastpath.c`): tests/test_fastpath.py, case for case, on
the port's runtime. Every test has a deadline after which it fails
instead of hanging, and every `get` and `wait` a timeout.

The reference's docstring:

Native control-plane hot path (native/fastpath.c).

Reference: the compiled submit/receive path (_raylet.pyx:3996) and
hand-rolled hot-RPC encodings (src/ray/protobuf/). The codec must
round-trip every hot frame shape bit-exactly against the pickle
fallback, reject truncated/corrupt input without crashing, and
interoperate per-message with pickle senders (magic-byte routing).
"""
import pickle
import signal

import pytest

from ray_tpu_torch._private import fastpath

DEADLINE_S = 120
GET_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _deadline():
    def expire(signum, frame):
        pytest.fail(f"test passed its {DEADLINE_S} s deadline")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(DEADLINE_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


fp = fastpath.get()
pytestmark = pytest.mark.skipif(fp is None, reason="no native toolchain")

TID = bytes(range(16))
CALL = (1, 7, TID, b"f" * 16, None, b"args-blob", 2, None, None)
ACTOR_CALL = (1, 8, TID, None, "method_name", b"", 1, b"a" * 16, "io")
REPLY_OK = (2, 7, None, [(b"inline", None, 6, ()), (None, "seg_9", 4096, (b"c" * 16, b"d" * 16))])
REPLY_ERR = (2, 9, b"pickled-exc", [])
RDY = ("RDY", (b"o" * 16,))


@pytest.mark.parametrize(
    "frame", [CALL, ACTOR_CALL, REPLY_OK, REPLY_ERR, RDY],
    ids=["call", "actor_call", "reply_ok", "reply_err", "rdy"],
)
def test_roundtrip_exact(frame):
    enc = fp.encode(frame)
    assert isinstance(enc, bytes) and enc[0] == 0xF1
    out = fp.decode(enc)
    assert out == frame
    # Same structure pickle would deliver (types too, not just ==).
    assert repr(out) == repr(pickle.loads(pickle.dumps(frame, 5)))


def test_batch_mixed_elements():
    batch = ("B", [CALL, {"type": "task_done", "n": 1}, REPLY_OK, RDY])
    enc = fp.encode(batch)
    assert enc is not None
    assert fp.decode(enc) == batch


def test_unsupported_shapes_fall_back():
    assert fp.encode({"type": "hello"}) is None
    assert fp.encode((99, "unknown-op")) is None
    assert fp.encode(("X", [1])) is None
    # lists of ids in RDY (the head builds tuples, but be liberal)
    assert fp.decode(fp.encode(("RDY", [b"o" * 16]))) == ("RDY", (b"o" * 16,))


def test_truncated_and_corrupt_input():
    enc = fp.encode(CALL)
    for cut in (1, 2, 5, len(enc) - 1):
        with pytest.raises(ValueError):
            fp.decode(enc[:cut])
    with pytest.raises(ValueError):
        fp.decode(b"\x80\x05garbage")  # pickle magic, not ours
    with pytest.raises(ValueError):
        fp.decode(b"\xf1\x63")  # bad kind


def test_return_oids_match_python():
    from ray_tpu_torch._private.ids import ObjectID

    tid = bytes(range(16))
    assert fp.return_oids(tid, 5) == [
        ObjectID.bytes_for_return(tid, i) for i in range(5)
    ]
    assert fp.return_oids(tid, 0) == []


def test_wait_partition_semantics():
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch.object_ref import ObjectRef

    refs = [ObjectRef(ObjectID(bytes([i]) * 16)) for i in range(6)]
    ready = {refs[1]._id._bytes, refs[3]._id._bytes, refs[5]._id._bytes}
    part = fp.wait_partition(refs, ready, 2)
    assert part is not None
    got, rest = part
    assert got == [refs[1], refs[3]]  # order preserved, capped at n
    assert rest == [refs[0], refs[2], refs[4], refs[5]]
    assert fp.wait_partition(refs, ready, 4) is None  # only 3 ready


def test_large_frame_roundtrip():
    big = (1, 2**31, TID, None, "m", b"x" * (1 << 20), 1, b"a" * 16, None)
    # req_id must fit u32; 2**31 does.
    assert fp.decode(fp.encode(big)) == big
