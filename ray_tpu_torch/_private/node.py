"""Head-node bring-up: session directory, GCS, resource detection.

Reference: python/ray/_private/node.py — Node starts GCS + raylet +
agents as subprocesses (start_head_processes :1342). Here the control
plane runs as threads in the driver process and workers are the only
subprocesses; the Node owns the session dir and shutdown.
"""
from __future__ import annotations

import hashlib
import os
import secrets
import shutil
import time
from typing import Dict, Optional

from .config import temp_root
from .gcs import GcsServer

#: Longest GCS socket path kept under the session dir. AF_UNIX takes at
#: most 107 bytes, and a caller's temp dir can be long (pytest's
#: `tmp_path` under xdist is over 100).
MAX_SESSION_SOCKET_PATH = 100


def gcs_socket_path(session_dir: str) -> str:
    """The GCS socket of a session: ``<session_dir>/gcs.sock`` when that
    fits AF_UNIX's limit, else ``/tmp/rtpt-<hash of the session dir>.sock``.
    The hash keeps it the same for a head restarted on the same dir."""
    path = os.path.join(session_dir, "gcs.sock")
    if len(path) <= MAX_SESSION_SOCKET_PATH:
        return path
    digest = hashlib.sha256(os.path.abspath(session_dir).encode()).hexdigest()
    return f"/tmp/rtpt-{digest[:24]}.sock"


def detect_num_gpus() -> int:
    """GPU detection, delegated to the accelerator manager (reference:
    _private/accelerators/nvidia_gpu.py). It never initialises CUDA."""
    from .accelerators import GPUAcceleratorManager

    return GPUAcceleratorManager.get_current_node_num_accelerators()


def default_resources(
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """CPU and GPU of this node. "TPU" is a plain resource here, as "GPU"
    is in the reference: it exists only where `resources` names it."""
    out: Dict[str, float] = {
        "CPU": float(num_cpus if num_cpus is not None else os.cpu_count() or 1),
    }
    gpus = num_gpus if num_gpus is not None else detect_num_gpus()
    if gpus:
        out["GPU"] = float(gpus)
    if resources:
        out.update({k: float(v) for k, v in resources.items()})
    return out


class Node:
    """Head node: owns the session and the in-process GCS.

    With ``tcp_port`` set (0 = pick a free port) the GCS also listens on
    the network, remote node daemons (raylet.py) can join the cluster,
    and the head runs an object-transfer server so remote nodes can pull
    objects sealed on the head.
    """

    def __init__(self, resources: Dict[str, float], temp_dir: Optional[str] = None,
                 tcp_port: Optional[int] = None,
                 session_dir: Optional[str] = None,
                 authkey: Optional[bytes] = None,
                 client_server_port: Optional[int] = None):
        if session_dir is None:
            base = temp_dir or temp_root()
            os.makedirs(base, exist_ok=True)
            session_dir = os.path.join(
                base,
                f"session_{int(time.time())}_{os.getpid()}_{secrets.token_hex(4)}",
            )
        # Fixed session_dir + authkey: a restarted head reuses the dir
        # and restores its persisted GCS state from it.
        self.session_dir = session_dir
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        self.address = gcs_socket_path(self.session_dir)
        self.authkey = authkey or secrets.token_bytes(16)
        # Node-wide C++ object-store pool (plasma equivalent); workers
        # inherit the name via the environment and attach.
        self._pool = None
        try:
            from .native_store import PoolStore, native_available

            if native_available():
                from .config import RayConfig

                pool_name = f"/rtpt_pool_{secrets.token_hex(4)}"
                self._pool = PoolStore(
                    pool_name,
                    create=True,
                    pool_bytes=RayConfig.object_store_memory_bytes or None,
                )
                os.environ["RAY_TPU_TORCH_POOL_NAME"] = pool_name
        except Exception:  # noqa: BLE001 - per-object segments fallback
            self._pool = None
        # Dead-client ledger sweep on the head segment: SIGKILLed
        # workers can't drain their refcounts, so the segment owner
        # reclaims them on the health-check cadence (the raylet does
        # the same for remote-node segments in its heartbeat loop).
        self._pool_sweep_stop = None
        if self._pool is not None:
            import threading

            from . import events as _events
            from .config import RayConfig

            stop = threading.Event()
            interval = RayConfig.health_check_period_ms / 1000.0

            def _sweep_loop(pool=self._pool):
                while not stop.wait(interval):
                    try:
                        swept = pool.sweep()
                    except Exception:  # noqa: BLE001 - destroyed segment
                        stop.set()  # shutdown race: end the loop
                        return
                    if swept.get("clients_swept") and _events.enabled():
                        _events.record(
                            _events.OBJECT, "head", "SHM_SWEEP", swept
                        )

            self._pool_sweep_stop = stop
            threading.Thread(
                target=_sweep_loop, name="pool-sweep", daemon=True
            ).start()
        self._transfer = None
        head_transfer_addr = ""
        if tcp_port is not None:
            from . import transport
            from .object_store import ObjectStore
            from .object_transfer import ObjectTransferServer

            self._transfer = ObjectTransferServer(
                ObjectStore(), f"{transport.node_ip()}:0", self.authkey
            )
            head_transfer_addr = self._transfer.address
        self.gcs = GcsServer(
            session_dir=self.session_dir,
            address=self.address,
            authkey=self.authkey,
            head_resources=resources,
            tcp_port=tcp_port,
            head_transfer_addr=head_transfer_addr,
        )
        self.tcp_address = self.gcs.tcp_address
        # Ray Client equivalent: remote drivers connect over
        # ``ray_tpu_torch://host:port?authkey`` (reference: util/client/server).
        self._client_proxy = None
        self.client_server_address: Optional[str] = None
        if client_server_port is not None:
            from .client_proxy import SCHEME, ClientProxyServer

            self._client_proxy = ClientProxyServer(
                self.address, self.authkey, port=client_server_port
            )
            self.client_server_address = (
                f"{SCHEME}{self._client_proxy.address}?{self.authkey.hex()}"
            )

    def shutdown(self, cleanup_session: bool = True):
        if self._client_proxy is not None:
            self._client_proxy.shutdown()
            self._client_proxy = None
        self.gcs.shutdown()
        if self._transfer is not None:
            self._transfer.shutdown()
            self._transfer = None
        if self._pool_sweep_stop is not None:
            self._pool_sweep_stop.set()
            self._pool_sweep_stop = None
        if self._pool is not None:
            try:
                self._pool.destroy()
            except Exception:  # noqa: BLE001
                pass
            self._pool = None
            os.environ.pop("RAY_TPU_TORCH_POOL_NAME", None)
        if cleanup_session:
            shutil.rmtree(self.session_dir, ignore_errors=True)
