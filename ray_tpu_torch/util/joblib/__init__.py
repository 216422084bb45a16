"""joblib backend over ray_tpu_torch: ``register_ray()`` +
``joblib.parallel_backend("ray_tpu_torch")`` fans sklearn/joblib workloads
over the cluster.

Reference: python/ray/util/joblib/__init__.py +
ray_backend.py (a Pool-backed joblib backend) — here implemented on
util.multiprocessing.Pool, whose sub-core actors co-host on shared
worker processes, so wide ``n_jobs`` stays cheap on small hosts.
"""
from __future__ import annotations

from typing import Any

__all__ = ["register_ray"]


def register_ray() -> None:
    """Register the "ray_tpu_torch" joblib parallel backend."""
    from joblib.parallel import register_parallel_backend

    register_parallel_backend("ray_tpu_torch", _RayTpuBackend)


def _make_backend():
    from joblib._parallel_backends import MultiprocessingBackend

    from ..multiprocessing import Pool

    class RayTpuBackend(MultiprocessingBackend):
        """joblib backend whose worker pool is cluster actors."""

        supports_timeout = True

        def effective_n_jobs(self, n_jobs):
            import ray_tpu_torch

            if n_jobs == 1:
                return 1
            total = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
            if n_jobs is None or n_jobs == -1:
                return max(1, total)
            return n_jobs

        def configure(self, n_jobs=1, parallel=None, prefer=None,
                      require=None, **kwargs):
            n_jobs = self.effective_n_jobs(n_jobs)
            self.parallel = parallel
            self._pool = Pool(n_jobs)
            return n_jobs

        def _get_pool(self):
            return self._pool

        def terminate(self):
            pool = getattr(self, "_pool", None)
            if pool is not None:
                pool.terminate()
                self._pool = None

    return RayTpuBackend


class _RayTpuBackendMeta(type):
    """Defer the joblib import until the backend is instantiated."""

    def __call__(cls, *args: Any, **kwargs: Any):
        return _make_backend()(*args, **kwargs)


class _RayTpuBackend(metaclass=_RayTpuBackendMeta):
    pass
