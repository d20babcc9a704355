"""Multi-process ingest plane: shared-memory columnar rings feeding one
engine.

Sentinel's product shape is "many request-serving threads, one
admission authority"; here the authority is the device engine, and the
columnar ingest spine (runtime/window.py) lets ONE process saturate it
— but host-side adapter encode is GIL-bound Python, so a single
front-end process is the scaling wall. This package makes the front
end horizontally scalable the way data-plane sketch systems split
front-end from authority (HashPipe, arXiv:1611.04825): N worker
processes encode admissions into a shared-memory **MPSC request ring**,
the engine process drains frames onto the existing columnar
``submit_bulk``/BatchWindow spine, and verdicts fan back through one
**SPSC response ring per worker** — pickle-free both ways.

Modules:

* :mod:`~sentinel_tpu_torch.ipc.ring` — fixed-slot rings over
  ``multiprocessing.shared_memory`` with seqlock-style slot headers,
  plus the control header (engine health word + heartbeat, per-worker
  heartbeat epochs, intern-table generation, failover-policy snapshot).
* :mod:`~sentinel_tpu_torch.ipc.frames` — the columnar frame codec: fixed
  numpy columns for ts/acquire/entry-type/origin/resource ids and the
  packed W3C traceparent, a varbytes region for args, and the
  per-connection intern protocol (each string crosses the boundary
  once).
* :mod:`~sentinel_tpu_torch.ipc.worker` — :class:`IngestClient`, the
  entry/exit/bulk API workers speak. The client holds no device state
  and does no device work — a worker process only ever touches numpy and
  shared memory. Its micro-window
  (``sentinel.tpu.ipc.client.window.*``) coalesces concurrent calls
  into one frame per bounded window.
* :mod:`~sentinel_tpu_torch.ipc.plane` — :class:`IngestPlane`, the
  engine-side drainer.
* :mod:`~sentinel_tpu_torch.ipc.worker_mode` — worker mode
  (``sentinel.tpu.ipc.worker.mode``): route a whole process's
  ``api.entry`` surface (and therefore every adapter) through its
  client; ``api.run_workers`` / ``python -m sentinel_tpu_torch.ipc.launch``
  make an N-process deployment one line.
* :mod:`~sentinel_tpu_torch.ipc.supervise` — the engine supervisor: the
  engine in a child process on named rings, restarted on a crash, a warm
  standby and a planned handoff (``api.run_engine_supervised``).

Config lives under ``sentinel.tpu.ipc.*`` (utils/config.py); the plane
is **off by default** — never constructed, no shared memory, at most
one attribute read on any engine hot path.
"""

from sentinel_tpu_torch.ipc.frames import IpcVerdict  # noqa: F401
from sentinel_tpu_torch.ipc.worker import IngestClient  # noqa: F401

__all__ = ["IngestClient", "IpcVerdict"]


def __getattr__(name):
    # IngestPlane pulls in the engine and its device state — resolve it
    # lazily so `import sentinel_tpu_torch.ipc` stays worker-light.
    if name == "IngestPlane":
        from sentinel_tpu_torch.ipc.plane import IngestPlane

        return IngestPlane
    raise AttributeError(name)
