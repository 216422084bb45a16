"""What the ranks of `tests/test_torch_parallel.py`'s staged world run.

`run_staged` runs a `ray_tpu_torch.parallel.launch` driver with every
exchange of the ring (`parallel.ring.start_shift`) and every gradient
all-reduce (`parallel.step.all_reduce_sum_`) going through host buffers,
as CUDA tensors go over gloo on the card. On the CPU these branches
would otherwise not run. It lives apart from the test files, which
import JAX: the ranks import this module and the port only.
"""


def _always_staged(group, t):
    return True


def run_staged(rank, world_size, driver, *args):
    from ray_tpu_torch.parallel import ring

    ring.host_staged = _always_staged
    return driver(rank, world_size, *args)
