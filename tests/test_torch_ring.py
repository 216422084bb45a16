"""The port's ring attention (ray_tpu_torch.ops.ring_attention) against the
JAX package's, on the CPU.

The port's ranks are gloo processes (`ray_tpu_torch.parallel.launch.spawn`:
a FileStore in a temporary directory, a 60 s process-group timeout, a
deadline that kills the world and fails the test); each world is spawned
once per module and runs all its cases. The JAX side runs as
`tests/test_parallel.py` runs it, on the 8-device virtual CPU mesh of the
root conftest. Inputs come from `np.random.RandomState` (`ring_inputs`).
On the CPU every ring block takes the plain versions of K1-K3, so only
the order of summation differs from the reference's blockwise XLA path.
"""
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from ray_tpu.ops import attention_reference
from ray_tpu.ops.ring_attention import ring_self_attention as jax_ring
from ray_tpu.parallel import MeshSpec as JaxMeshSpec
from ray_tpu_torch.ops import ring_attention as R
from ray_tpu_torch.parallel.launch import ring_inputs, run_ring, spawn
from ray_tpu_torch.parallel.mesh import MeshSpec

# The reference tests' own tolerances (tests/test_parallel.py).
O_ATOL = 2e-5
GRAD_ATOL = 5e-5
DEADLINE_S = 180

SEQ4_CASES = {
    "causal": dict(inputs=(0, 2, 4, 4, 128, 16), causal=True),
    "non-causal": dict(inputs=(0, 2, 4, 4, 128, 16), causal=False),
    "grads": dict(inputs=(1, 1, 2, 2, 64, 8), causal=True),
}
GQA_CASE = dict(inputs=(2, 1, 8, 2, 64, 16), causal=True)  # 8 heads over 2, seq 2


def _gather(results, case_index, name):
    """The `name` shards of every rank in seq order, joined along T; with
    several data replicas, the first (the tests check they agree)."""
    parts = {}
    for r in results:
        parts.setdefault(r[case_index]["seq_rank"], r[case_index][name])
    return torch.cat([parts[i] for i in sorted(parts)], dim=2).numpy()


@pytest.fixture(scope="module")
def seq4():
    return spawn(run_ring, 4, MeshSpec(seq=4), list(SEQ4_CASES.values()), "cpu",
                 deadline_s=DEADLINE_S)


@pytest.fixture(scope="module")
def seq2():
    # 4 ranks as 2 data replicas x a ring of 2.
    return spawn(run_ring, 4, MeshSpec(data=2, seq=2), [GQA_CASE], "cpu",
                 deadline_s=DEADLINE_S)


def _jax_ring_vjp(inputs, causal, seq):
    q, k, v, do = (jnp.asarray(x) for x in ring_inputs(*inputs))
    mesh = JaxMeshSpec(seq=seq).build()
    o, vjp = jax.vjp(lambda q_, k_, v_: jax_ring(q_, k_, v_, mesh, causal=causal), q, k, v)
    return [np.asarray(x) for x in (o, *vjp(do))]


def _jax_dense_vjp(inputs, causal):
    q, k, v, do = (jnp.asarray(x) for x in ring_inputs(*inputs))
    o, vjp = jax.vjp(lambda q_, k_, v_: attention_reference(q_, k_, v_, causal=causal), q, k, v)
    return [np.asarray(x) for x in (o, *vjp(do))]


@pytest.mark.parametrize("name", ["causal", "non-causal"])
def test_ring_attention_matches_dense(seq4, name):
    case = SEQ4_CASES[name]
    index = list(SEQ4_CASES).index(name)
    got = _gather(seq4, index, "o")
    want_ring = _jax_ring_vjp(case["inputs"], case["causal"], 4)[0]
    want_dense = _jax_dense_vjp(case["inputs"], case["causal"])[0]
    np.testing.assert_allclose(got, want_ring, atol=O_ATOL)
    np.testing.assert_allclose(got, want_dense, atol=O_ATOL)


def test_ring_attention_grads_match_dense(seq4):
    case = SEQ4_CASES["grads"]
    index = list(SEQ4_CASES).index("grads")
    ring = _jax_ring_vjp(case["inputs"], True, 4)
    dense = _jax_dense_vjp(case["inputs"], True)
    for name, want_ring, want_dense in zip(("o", "dq", "dk", "dv"), ring, dense):
        got = _gather(seq4, index, name)
        np.testing.assert_allclose(got, want_ring, atol=GRAD_ATOL, err_msg=name)
        np.testing.assert_allclose(got, want_dense, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("name", ["causal", "non-causal"])
def test_ring_attention_backward_matches_dense(seq4, name):
    """dq, dk and dv at the forward tests' shape, causal and not."""
    case = SEQ4_CASES[name]
    index = list(SEQ4_CASES).index(name)
    dense = _jax_dense_vjp(case["inputs"], case["causal"])
    for name_, want in zip(("dq", "dk", "dv"), dense[1:]):
        np.testing.assert_allclose(_gather(seq4, index, name_), want, atol=GRAD_ATOL,
                                   err_msg=name_)


def test_ring_attention_gqa(seq2):
    ring = _jax_ring_vjp(GQA_CASE["inputs"], True, 2)
    dense = _jax_dense_vjp(GQA_CASE["inputs"], True)
    np.testing.assert_allclose(_gather(seq2, 0, "o"), ring[0], atol=O_ATOL)
    np.testing.assert_allclose(_gather(seq2, 0, "o"), dense[0], atol=O_ATOL)
    # KV-head gradients summed back over each group of 4 query heads.
    for name, want in zip(("dq", "dk", "dv"), dense[1:]):
        np.testing.assert_allclose(_gather(seq2, 0, name), want, atol=GRAD_ATOL, err_msg=name)


def test_data_replicas_of_a_ring_agree(seq2):
    by_seq = {}
    for r in seq2:
        by_seq.setdefault(r[0]["seq_rank"], []).append(r[0])
    assert sorted(by_seq) == [0, 1]
    for replicas in by_seq.values():
        assert len(replicas) == 2
        for name in ("o", "dq", "dk", "dv"):
            assert torch.equal(replicas[0][name], replicas[1][name]), name


@pytest.fixture
def fake_world():
    """`init(rank, n)`: this process as rank `rank` of a fake world of `n`
    (collectives are no-ops), torn down after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(rank, n):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)
        return dist.group.WORLD

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_future_blocks_run_no_kernel(fake_world, n, causal):
    """Rank r of a causal ring runs r + 1 blocks forward and backward (the
    diagonal and the r earlier shards; the reference computes the n - r - 1
    future blocks and masks them out), a non-causal ring n blocks. Every
    rank shifts k/v n - 1 times forward; backward it shifts k/v n - 1
    times, the dk/dv accumulators n - 2 times (none at the first step,
    where nobody has added to them) and once more home. Counted on the
    calls of `flash_fwd` / `flash_bwd`, which launch K1 / K2 + K3 on the
    card; the values match the reference in the tests above."""
    for rank in range(n):
        group = fake_world(rank, n)
        q, k, v = (torch.randn(1, 2, 8, 8, requires_grad=True) for _ in range(3))
        with mock.patch.object(R, "flash_fwd", wraps=R.flash_fwd) as fwd, \
                mock.patch.object(R, "flash_bwd", wraps=R.flash_bwd) as bwd, \
                mock.patch.object(R, "start_shift", wraps=R.start_shift) as shift, \
                mock.patch.object(R, "ring_shift", wraps=R.ring_shift) as home:
            o = R.ring_attention(q, k, v, group=group, causal=causal)
            assert (fwd.call_count, shift.call_count) == (rank + 1 if causal else n, n - 1)
            o.sum().backward()
        blocks = rank + 1 if causal else n
        assert fwd.call_count == blocks
        assert bwd.call_count == blocks
        assert shift.call_count == (n - 1) + (n - 1) + (n - 2)
        assert home.call_count == 1
        causal_flags = [c.kwargs["causal"] for c in fwd.call_args_list]
        assert causal_flags == [causal] + [False] * (blocks - 1)


def test_merge_keeps_a_float32_accumulator():
    o_a, o_b = torch.randn(2, 3, 4).bfloat16(), torch.randn(2, 3, 4).bfloat16()
    lse_a, lse_b = torch.randn(2, 3), torch.randn(2, 3)
    o, lse = R._merge(o_a, lse_a, o_b, lse_b)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    w = torch.softmax(torch.stack([lse_a, lse_b]), dim=0)[..., None]
    torch.testing.assert_close(o, w[0] * o_a.float() + w[1] * o_b.float())
    torch.testing.assert_close(lse, torch.logaddexp(lse_a, lse_b))


def test_ring_attention_rejects_unrepeated_kv_heads():
    q = torch.zeros(1, 4, 8, 8)
    kv = torch.zeros(1, 2, 8, 8)
    with pytest.raises(ValueError):
        R.ring_attention(q, kv, kv, group=None)


def test_spawn_raises_with_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="MeshSpec needs 4 devices, have 2"):
        spawn(run_ring, 2, MeshSpec(seq=4), [], "cpu", deadline_s=DEADLINE_S)


def test_drivers_take_the_card_unless_asked_for_the_cpu():
    """Entry points run on the card: without one, a driver given no device
    raises on every rank instead of running on the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        spawn(run_ring, 1, MeshSpec(), [], deadline_s=DEADLINE_S)


def test_spawn_kills_a_world_past_its_deadline():
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="deadline of 0.5 s"):
        spawn(run_ring, 2, MeshSpec(seq=2), [GQA_CASE], "cpu", deadline_s=0.5)
    assert time.monotonic() - t0 < 30


def test_build_lock_excludes_other_processes_and_skips_what_they_built(tmp_path, monkeypatch):
    """Ranks that start together build under one `flock`; one that gets
    the lock after another built a library loads it: nvcc is not run."""
    import fcntl

    from ray_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise AssertionError("nvcc must not run for a library already built")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    src = _build.CSRC / "flash_fwd.cu"
    lib = _build._library_path(src)
    assert lib.parent == tmp_path
    with _build._build_dir_lock():
        with open(tmp_path / ".lock", "w") as other:
            with pytest.raises(BlockingIOError):
                fcntl.flock(other, fcntl.LOCK_EX | fcntl.LOCK_NB)
        lib.write_bytes(b"")
        _build._report_path(lib).write_text("ptxas report")
        _build._compile({src: lib})
