"""paddle_tpu_torch.fleet — continuous batching and the replicated
serving fleet (counterpart of ``paddle_tpu.fleet``).

- :mod:`batching` — **continuous batching**: coalesce queued requests
  into the largest exported bucket within a latency budget
  (:class:`BatchPolicy`), per-request row spans slicing outputs back per
  caller. Wired into ``PredictorServer(batch_policy=...)``.
- :mod:`router` — :class:`FleetRouter`: N ``PredictorServer`` replicas
  (spawned in-process from an artifact, or adopted) behind health-aware
  least-loaded routing with shared shed/deadline policy at the front
  door, retry of never-dispatched requests after a replica death
  (at-most-once for dispatched ones), rolling hot reload (canary one
  replica, fan out, roll back on failure), and an aggregated
  ``/metrics`` endpoint merging every replica's series under a
  ``replica`` label.
- :mod:`decode` — the decode-side serving workload: the GPT generator
  (prefill through the flash forward kernel, captured decode steps)
  served through the batching scheduler.
- :mod:`remote` + :mod:`replica_main` + :mod:`agent` — the
  **cross-process** and **cross-host** fleet:
  ``FleetRouter.spawn(..., remote=True)`` launches each replica as a
  separate OS process serving the submit/health/kill/reload surface over
  the length-prefixed framed wire (trace tokens ride the header; the
  at-most-once ``ReplicaDied`` contract holds against real SIGKILL and
  TCP partitions); ``hosts=[...]`` adopts replicas from per-host agents
  that ship artifacts over FETCH/ARTIFACT.

- :mod:`autoscaler` — the **closed loop**: a control thread watching
  the telemetry collector's ``/query`` trends and ``/alerts``
  transitions and sizing the fleet within a band via
  ``FleetRouter.grow()`` / ``retire(drain=True)`` — pure decision core
  (:class:`AutoscalePolicy`: hysteresis, per-direction cooldowns,
  anti-flap, quorum floor, fail-static on stale data).
"""

from .batching import BatchPolicy

_ROUTER_NAMES = ("FleetRouter", "FleetPending", "NoReplicaAvailable")
_DECODE_NAMES = ("export_decoder", "decode_server")
_REMOTE_NAMES = ("RemoteReplica", "RemotePending", "ReplicaProcess",
                 "spawn_replica", "spawn_fleet")
_AUTOSCALER_NAMES = ("Autoscaler", "AutoscalePolicy", "HttpCollectorReader",
                     "LocalCollectorReader", "ScaleDecision", "ScaleSignals",
                     "complete_buckets")


def __getattr__(name):
    # router/decode/remote import serving (which imports batching above):
    # resolving them lazily keeps the package importable from serving.py
    # without a cycle
    if name in _ROUTER_NAMES:
        from . import router
        return getattr(router, name)
    if name in _DECODE_NAMES:
        from . import decode
        return getattr(decode, name)
    if name in _REMOTE_NAMES:
        from . import remote
        return getattr(remote, name)
    if name in _AUTOSCALER_NAMES:
        from . import autoscaler
        return getattr(autoscaler, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["BatchPolicy", *_ROUTER_NAMES, *_DECODE_NAMES, *_REMOTE_NAMES,
           *_AUTOSCALER_NAMES]
