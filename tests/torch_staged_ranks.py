"""What the ranks of the port's multi-process tests run around a function
of `ray_tpu_torch.parallel.launch`.

`run_staged` runs such a function with every exchange of the ring
(`parallel.ring.start_shift`) and every gradient all-reduce
(`parallel.collectives.all_reduce_sum_`) going through host buffers, as
CUDA tensors go over gloo on the card. On the CPU these branches would
otherwise not run.

`run_counted` runs one with the attention and grouped-matmul kernels'
plain versions counted in `ops.attention.LAUNCHES` and
`ops.gmm.LAUNCHES`, as the kernels count their launches
on the card, so that a CPU test can hold its launches to what
`chip_smoke.py` expects of the card.

They live apart from the test files, which import JAX: the ranks import
this module and the port only.
"""


def _always_staged(group, t):
    return True


def run_staged(rank, world_size, fn, *args):
    from ray_tpu_torch.parallel import ring

    ring.host_staged = _always_staged
    return fn(rank, world_size, *args)


def _counted(launches, name, fn):
    def run(*args, **kwargs):
        launches[name] += 1
        return fn(*args, **kwargs)

    return run


def run_counted(rank, world_size, fn, *args):
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.ops import gmm as G

    for module in (A, G):
        for name in module.LAUNCHES:
            plain = f"_{name}_plain"
            setattr(module, plain, _counted(module.LAUNCHES, name, getattr(module, plain)))
    return fn(rank, world_size, *args)
