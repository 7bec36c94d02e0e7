"""FleetRouter: N ``PredictorServer`` replicas behind one front door
(counterpart of ``paddle_tpu.fleet.router``, with its wire, its journal
event names and its ``paddle_tpu_fleet_*`` series). The router owns three
contracts a single replica cannot:

- **Health-aware least-loaded routing** — every submit consults each
  replica's ``health()`` (the same state machine ``/healthz`` serves):
  not-ready replicas (breaker open, draining, dead) are skipped, and
  among ready ones the lowest ``queue_depth + workers_busy`` wins.
  Shed/deadline policy is shared at the front door: the router's
  ``default_deadline`` applies fleet-wide, and when every replica
  rejects, ONE typed error surfaces (:class:`~paddle_tpu_torch.serving.
  ServerOverloaded` if the fleet is saturated, :class:`~paddle_tpu_torch.
  serving.CircuitOpen` if every replica's breaker is open,
  :class:`NoReplicaAvailable` otherwise).
- **Retry-on-replica-death, at-most-once for dispatched work** — a
  request that fails with :class:`~paddle_tpu_torch.serving.ServerClosed`
  was provably never dispatched (the replica's queue/kill paths
  guarantee it): :class:`FleetPending` transparently resubmits it to
  another replica. A request that was dispatched when its replica died
  surfaces :class:`~paddle_tpu_torch.serving.ReplicaDied` exactly once
  and is never retried.
- **Rolling hot reload** — :meth:`FleetRouter.reload` canaries ONE
  replica first (its own golden-feed canary + static preflight), then
  fans out; a canary failure touches nothing else, a mid-rollout
  failure rolls the already-swapped replicas back to the previous
  artifact. No in-flight request is dropped (each swap is the
  replica's own zero-drop reload).

Observability: :meth:`FleetRouter.metrics_families` merges every
replica's ``telemetry_families()`` under a ``replica`` label
(:func:`paddle_tpu_torch.telemetry.merge_exports`) plus the router's own
``paddle_tpu_fleet_*`` series, and :meth:`FleetRouter.serve_metrics`
exposes the merged export at one ``/metrics`` endpoint (Prometheus
text, ``?format=json`` for JSON) with the fleet ``health()`` behind
``/healthz``.

Replicas live on ``device`` (the CUDA card by default): in-process ones
share the loaded weights, and each process replica loads its own. On
the card in-process replicas share the card's streams: a replica's
warm-up or a reload's candidate captures its CUDA graphs while its
siblings serve, and each server waits only on its own outputs
(``io._block_on``).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..serving import (CircuitOpen, PendingResult, PredictorServer,
                       ReloadFailed, ServerClosed, ServerOverloaded,
                       ServingError)


def _log():
    import logging
    return logging.getLogger("paddle_tpu_torch.fleet")


class NoReplicaAvailable(ServingError):
    """No replica could accept the request (none ready, or every ready
    replica rejected it with mixed reasons). Carries the per-replica
    states for the reject reply."""

    def __init__(self, states: Dict[str, str]):
        super().__init__(f"no replica available: {states}")
        self.states = dict(states)


class _Replica:
    __slots__ = ("name", "server")

    def __init__(self, name: str, server: PredictorServer):
        self.name = name
        self.server = server


class FleetPending:
    """Front-door handle over a routed request. ``result()`` surfaces
    the replica's typed outcome — except :class:`ServerClosed`, the
    never-dispatched signal, which triggers a transparent reroute to
    another replica (each replica tried at most once per request;
    deadline budget carried across reroutes as an absolute point)."""

    def __init__(self, router: "FleetRouter", feed: Dict[str, Any],
                 replica: str, inner: PendingResult,
                 abs_deadline: Optional[float]):
        self._router = router
        self._feed = feed
        self._inner = inner
        self._abs_deadline = abs_deadline
        self.replica = replica          # current (latest) replica
        self.tried = [replica]          # routing history

    @property
    def span(self) -> Optional[str]:
        """The CURRENT attempt's trace id (a reroute mints a new span
        on the new replica; ``tried`` still names every hop)."""
        return self._inner.span

    def done(self) -> bool:
        return self._inner.done()

    @property
    def latency(self) -> Optional[float]:
        return self._inner.latency

    def result(self, timeout: Optional[float] = None):
        # `timeout` bounds the WHOLE call, reroutes included — a
        # replica death must not restart the caller's clock
        bound = None if timeout is None else time.monotonic() + timeout
        while True:
            if bound is not None:
                timeout = max(0.0, bound - time.monotonic())
            try:
                return self._inner.result(timeout)
            except (ServerClosed, CircuitOpen):
                # never dispatched: both outcomes are only ever raised
                # BEFORE a request reaches an executable (ServerClosed
                # = the replica died/stopped with it queued, CircuitOpen
                # = the breaker tripped while it sat queued), so a
                # reroute cannot double-execute. At-most-once holds —
                # a DISPATCHED request on a dead replica raises
                # ReplicaDied, which this except does not catch.
                rel = None
                if self._abs_deadline is not None:
                    rel = self._abs_deadline - time.monotonic()
                replica, inner = self._router._route(
                    self._feed, rel, exclude=set(self.tried),
                    retry_of=self._inner.span)
                self.replica = replica
                self.tried.append(replica)
                self._inner = inner


class FleetRouter:
    """Supervise N ``PredictorServer`` replicas behind health-aware
    least-loaded routing (see the module docstring for the routing /
    retry / reload contracts).

    ``replicas``: dict ``{name: PredictorServer}`` (or a list, named
    ``r0..rN-1``) to ADOPT existing servers, or use :meth:`spawn` to
    build N replicas in-process from a ``save_inference_model``
    artifact (one load, executables shared via ``Predictor.clone``).
    ``dirname`` (remembered by :meth:`spawn`/:meth:`reload`) is the
    currently-served artifact — the rollback target for a failed
    rolling reload and the source for :meth:`replace`. ``server_kw``
    is the ``PredictorServer`` kwargs a dirname-based :meth:`replace`
    respawns with (``spawn`` records its own; an ADOPTED fleet that
    wants dirname respawns must pass the kwargs its replicas were
    built with, or the replacement would silently come up with default
    workers/queue/no batch policy)."""

    def __init__(self, replicas, default_deadline: Optional[float] = None,
                 dirname: Optional[str] = None,
                 server_kw: Optional[Dict[str, Any]] = None,
                 probe_timeout: Optional[float] = None,
                 remote: bool = False,
                 remote_kw: Optional[Dict[str, Any]] = None,
                 agents: Optional[List[Any]] = None,
                 link=None, device=None):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        if not isinstance(replicas, dict):
            replicas = {f"r{i}": srv for i, srv in enumerate(replicas)}
        self._replicas: Dict[str, _Replica] = {
            name: _Replica(name, srv) for name, srv in replicas.items()}
        self.default_deadline = default_deadline
        # reassigned (whole-reference) under the router lock on reload;
        # replace()'s lock-free read may spawn from the previous
        # artifact during a concurrent reload — stale but never torn
        self.dirname = dirname   # lint: allow(thread:unguarded-access)
        self._server_kw: Dict[str, Any] = dict(server_kw or {})
        # probe_timeout bounds EVERY replica health probe the router
        # takes (aggregation and routing): a probe that never returns
        # (a wedged in-process health(), a partitioned remote whose own
        # socket bound misbehaves) is abandoned at the bound and the
        # replica marked unavailable — the router stays responsive.
        # None (the in-process default) keeps probes inline and free.
        self.probe_timeout = probe_timeout
        self._remote = bool(remote)
        self._remote_kw: Dict[str, Any] = dict(remote_kw or {})
        # cross-host adoption (spawn(hosts=...)): the per-host agents
        # replace() respawns through, and the link factory that maps a
        # replica's advertised addr (drills route every cross-"host"
        # connection through a LinkProxy; production may NAT)
        self._agents: List[Any] = list(agents or [])
        self._link = link
        # where a respawned replica loads (None: the CUDA card)
        self.device = device
        self._journal_ship_seq: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._reload_lock = threading.Lock()
        self._rr = 0                     # round-robin tie-breaker
        self._counters: Dict[str, float] = {
            "submitted": 0, "rerouted": 0, "shed": 0,
            "replicas_replaced": 0, "replicas_grown": 0,
            "replicas_retired": 0, "reloads": 0, "reload_rollbacks": 0,
            "reload_failures": 0}
        self._routed: Dict[str, int] = {n: 0 for n in self._replicas}
        self._telemetry_server = None
        from ..telemetry import get_registry
        from ..telemetry.shipper import maybe_auto_ship
        self.telemetry_inst = get_registry().next_instance("fleet")
        self._telemetry_cid = get_registry().add_collector(
            FleetRouter._own_families, owner=self)
        # push shipping: PDTPU_TELEMETRY_ADDR streams the router
        # process's journal + registry (its fleet_* series included)
        # to the telemetry collector; remote replicas inherit the env
        # var and ship per-process on their own
        maybe_auto_ship()

    @property
    def journal(self):
        # resolved per use, not cached at construction: the process
        # journal can be swapped (tests, re-rooted sinks) after a
        # long-lived router was built
        from ..telemetry import get_journal
        return get_journal()

    # -- construction --------------------------------------------------------

    @classmethod
    def spawn(cls, dirname: str, replicas: int = 2,
              default_deadline: Optional[float] = None,
              remote: bool = False,
              remote_kw: Optional[Dict[str, Any]] = None,
              probe_timeout: Optional[float] = None,
              hosts: Optional[List[Any]] = None,
              link=None, device=None,
              **server_kw) -> "FleetRouter":
        """Build a fleet from one artifact.

        In-process (default): the model is loaded (and each bucket warmed)
        ONCE, then each replica gets its own ``PredictorServer`` over a
        ``Predictor.clone()`` — executables and device weights shared,
        queues/workers/breakers per replica.

        ``remote=True``: each replica is a separate OS process
        (:mod:`paddle_tpu_torch.fleet.remote` — ``replica_main`` serving the
        framed wire), launched concurrently and adopted as
        :class:`~paddle_tpu_torch.fleet.remote.RemoteReplica` proxies. Each
        process pays its own artifact load + warm-up but owns its
        GIL and dies for real (SIGKILL, partitions). ``remote_kw``
        tunes the proxies (probe_timeout, slow_after, submit_timeout,
        ...); the router's ``probe_timeout`` defaults to 2s for a
        remote fleet so health aggregation is bounded even when a
        probe wedges.

        ``server_kw`` (workers, queue_size, batch_policy, golden_feed,
        ...) applies to every replica either way — for a remote fleet
        it is shipped to the child processes (and re-used verbatim by
        :meth:`replace` respawns).

        ``hosts=["host:port", ...]`` (implies remote): adopt replicas
        from per-host fleet agents (``python -m paddle_tpu_torch.fleet.
        agent``) round-robin — the artifact is shipped to each host
        over FETCH/ARTIFACT (no shared filesystem assumed), the agents
        are kept for :meth:`replace` respawns (a replica whose whole
        host died respawns via a SURVIVING host's agent, artifact
        re-shipped as needed), and ``link`` optionally wraps every
        replica addr (drills: a ``LinkProxy`` per link).

        ``device`` is where every replica loads the artifact (the CUDA
        card by default; ``"cpu"`` for a CPU fleet), in this process or
        in each replica process."""
        if hosts:
            from . import remote as _remote

            agents, servers = _remote.spawn_host_fleet(
                dirname, hosts, replicas=replicas, remote_kw=remote_kw,
                link=link, device=device, **server_kw)
            return cls(servers, default_deadline=default_deadline,
                       dirname=dirname, server_kw=server_kw,
                       probe_timeout=(2.0 if probe_timeout is None
                                      else probe_timeout),
                       remote=True, remote_kw=remote_kw, agents=agents,
                       link=link, device=device)
        if remote:
            from . import remote as _remote

            servers = _remote.spawn_fleet(dirname, replicas=replicas,
                                          remote_kw=remote_kw, device=device,
                                          **server_kw)
            return cls(servers, default_deadline=default_deadline,
                       dirname=dirname, server_kw=server_kw,
                       probe_timeout=(2.0 if probe_timeout is None
                                      else probe_timeout),
                       remote=True, remote_kw=remote_kw, device=device)
        from ..io import load_inference_model

        base = load_inference_model(dirname, device=device)
        servers = {}
        for i in range(int(replicas)):
            servers[f"r{i}"] = PredictorServer(
                base if i == 0 else base.clone(), **server_kw)
        return cls(servers, default_deadline=default_deadline,
                   dirname=dirname, server_kw=server_kw,
                   probe_timeout=probe_timeout, device=device)

    # -- replica access ------------------------------------------------------

    @property
    def replica_names(self) -> List[str]:
        with self._lock:
            return list(self._replicas)

    def replica(self, name: str) -> PredictorServer:
        with self._lock:
            return self._replicas[name].server

    def replace(self, name: str,
                server: Optional[PredictorServer] = None) -> PredictorServer:
        """Swap a (typically dead) replica for a fresh one: an explicit
        ``server``, or one respawned from the fleet's current artifact
        (``spawn``-built fleets). The old server is killed if still
        live; routing picks the replacement up on the next submit —
        the recovery half of the kill drill."""
        if server is None:
            server = self._respawn(name, verb="replace")
        with self._lock:
            old = self._replicas.get(name)
            self._replicas[name] = _Replica(name, server)
            self._routed.setdefault(name, 0)
            self._journal_ship_seq.pop(name, None)
            self._counters["replicas_replaced"] += 1
        if old is not None:
            try:
                old_state = old.server.health()["state"]
            except Exception:  # a dead remote probes as unreachable
                old_state = "unreachable"
            if old_state != "stopped":
                old.server.kill(reason=f"replaced by router ({name})")
        # the replacement's artifact load moved the process-wide preparation
        # count (io.aot_compile_count): re-pin the SIBLINGS' compiles_since_warmup so the
        # off-path load doesn't read as a request-path recompile
        self._repin_all()
        self.journal.emit("fleet.replace", inst=self.telemetry_inst,
                          replica=name)
        return server

    def _respawn(self, name: str, verb: str = "respawn"):
        """Build a fresh server for ``name`` from the fleet's recorded
        artifact + server_kw, the same way the fleet was originally
        built: through a live host agent (cross-host), as a new OS
        process (remote), or in-process over a fresh artifact load.
        Shared by :meth:`replace` (death recovery) and :meth:`grow`
        (autoscale)."""
        if self.dirname is None:
            raise ValueError(
                f"{verb}({name!r}) needs an explicit server for an "
                "adopted fleet (no artifact dirname on record)")
        if not self._server_kw:
            _log().warning(
                "%s(%r): no server_kw on record (adopted fleet) — "
                "the new replica comes up with PredictorServer "
                "defaults; pass server_kw to FleetRouter to respawn "
                "with the fleet's real config", verb, name)
        if self._remote and self._agents:
            # cross-host: spawn through a LIVE host agent — preferring
            # the replica's previous host if any (warm artifact cache),
            # falling back to any surviving one — with the artifact
            # shipped over FETCH (a content-addressed no-op when that
            # host's cache already holds it)
            from . import remote as _remote
            with self._lock:
                cur = self._replicas.get(name)
            prefer = getattr(getattr(cur, "server", None), "agent", None)
            agent = self._pick_agent(prefer=prefer)
            return _remote.adopt_replica(
                agent, self.dirname, name,
                remote_kw=dict(self._remote_kw), link=self._link,
                device=self.device, **self._server_kw)
        if self._remote:
            # a remote fleet spawns a PROCESS from the artifact — the
            # recovery half of the process-kill drill, and the grow
            # half of the autoscale drill
            from . import remote as _remote
            return _remote.spawn_replica(
                self.dirname, remote_kw=dict(self._remote_kw, name=name),
                device=self.device, **self._server_kw)
        from ..io import load_inference_model
        return PredictorServer(
            load_inference_model(self.dirname, device=self.device),
            **self._server_kw)

    def grow(self, name: Optional[str] = None) -> str:
        """Add one replica to the fleet (the autoscaler's scale-up
        primitive): spawn from the recorded artifact the same way the
        fleet was built — locally, as a remote process, or through a
        host agent — and enter it into routing. ``name`` defaults to
        the first free ``r{i}`` slot; returns the name. Routing picks
        the newcomer up on the next submit (least-loaded ready replica
        wins, and an empty fresh queue is maximally attractive)."""
        if name is None:
            with self._lock:
                taken = set(self._replicas)
            i = 0
            while f"r{i}" in taken:
                i += 1
            name = f"r{i}"
        else:
            with self._lock:
                if name in self._replicas:
                    raise ValueError(f"grow({name!r}): name already in "
                                     "the fleet")
        server = self._respawn(name, verb="grow")
        with self._lock:
            if name in self._replicas:  # lost a race with another grow
                self._lockless_kill(server, f"grow({name}) raced")
                raise ValueError(f"grow({name!r}): name already in "
                                 "the fleet")
            self._replicas[name] = _Replica(name, server)
            self._routed.setdefault(name, 0)
            self._journal_ship_seq.pop(name, None)
            self._counters["replicas_grown"] += 1
        # the newcomer's artifact load moved the process-wide preparation
        # counter: re-pin the siblings (same reason as replace())
        self._repin_all()
        self.journal.emit("fleet.grow", inst=self.telemetry_inst,
                          replica=name)
        return name

    @staticmethod
    def _lockless_kill(server, reason: str) -> None:
        try:
            server.kill(reason=reason)
        except Exception:  # pragma: no cover - teardown best effort
            pass

    def retire(self, name: str, drain: bool = True,
               timeout: Optional[float] = None) -> None:
        """Remove ``name`` from the fleet (the autoscaler's scale-down
        primitive) WITHOUT dropping accepted work: the replica leaves
        routing first (new submits can no longer pick it, and a
        rerouted :class:`FleetPending` won't re-pick it either), then
        the server is closed with ``drain=True`` — dispatched requests
        run to completion, queued-but-never-dispatched ones surface
        ``ServerClosed`` and the fleet future transparently reroutes
        them to a surviving replica, so the at-most-once
        ``ReplicaDied``/``ServerClosed`` classification is preserved
        end to end. For a remote replica the drain rides the wire
        SHUTDOWN and the owning agent reaps the process (``close()``
        on :class:`~paddle_tpu_torch.fleet.remote.RemoteReplica` already
        STOPs through the agent that spawned it).

        Refuses to retire the LAST replica — an empty fleet cannot
        reroute anything (scale the band's floor with the policy's
        ``min_replicas`` instead)."""
        with self._lock:
            if name not in self._replicas:
                raise KeyError(f"retire({name!r}): no such replica "
                               f"(have {sorted(self._replicas)})")
            if len(self._replicas) == 1:
                raise ValueError(
                    f"retire({name!r}): refusing to retire the last "
                    "replica — an empty fleet cannot reroute")
            rep = self._replicas.pop(name)
            self._routed.pop(name, None)
            self._journal_ship_seq.pop(name, None)
            self._counters["replicas_retired"] += 1
        try:
            rep.server.close(drain=drain, timeout=timeout)
        except Exception as e:
            # a wedged drain must not leave a zombie process serving
            # nothing: fall back to the kill path (queued work gets the
            # at-most-once ServerClosed/ReplicaDied classification and
            # reroutes — the replica is already out of routing)
            _log().warning("retire(%r): drain close failed (%s: %s) — "
                           "killing", name, type(e).__name__, e)
            self._lockless_kill(rep.server, f"retired by router ({name})")
        self.journal.emit("fleet.retire", inst=self.telemetry_inst,
                          replica=name, drain=bool(drain))

    def _pick_agent(self, prefer=None):
        """First host agent that answers a PS probe (``prefer`` tried
        first — respawning on the replica's own host reuses its warm
        artifact cache). A whole-host kill takes that host's agent
        with it; the surviving agents are exactly the hosts replace()
        may respawn on."""
        agents = list(self._agents)
        if prefer is not None and prefer in agents:
            agents.remove(prefer)
            agents.insert(0, prefer)
        errors = []
        for agent in agents:
            try:
                agent.ps()
                return agent
            except Exception as e:
                errors.append(f"{agent!r}: {type(e).__name__}: {e}")
        raise ConnectionError(
            f"no live fleet agent to respawn on: {'; '.join(errors)}")

    def _repin_all(self) -> None:
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            try:
                rep.server.repin_compiles()
            except Exception:  # a dead replica has nothing to re-pin
                pass

    # -- request path --------------------------------------------------------

    def submit(self, feed: Dict[str, Any],
               deadline: Optional[float] = None) -> FleetPending:
        """Route one request to the least-loaded ready replica.
        ``deadline`` (seconds from now; falls back to the router's
        ``default_deadline``) is the FLEET-WIDE budget — reroutes after
        a replica death spend the same clock. Raises the front-door
        shed error when no replica accepts."""
        rel = self.default_deadline if deadline is None else deadline
        replica, inner = self._route(feed, rel)
        # counted only once a replica ACCEPTED it (shed requests are
        # counted by _route as shed, not as accepted intake)
        with self._lock:
            self._counters["submitted"] += 1
        abs_deadline = None if rel is None else time.monotonic() + rel
        return FleetPending(self, feed, replica, inner, abs_deadline)

    def run(self, feed: Dict[str, Any], timeout: Optional[float] = None):
        """Synchronous submit+wait (the ``PredictorServer.run``
        mirror)."""
        deadline = timeout if self.default_deadline is None else None
        return self.submit(feed, deadline=deadline).result(timeout)

    def _route(self, feed: Dict[str, Any], rel_deadline: Optional[float],
               exclude: Optional[set] = None,
               retry_of: Optional[str] = None
               ) -> Tuple[str, PendingResult]:
        """One routing pass: try ready replicas least-loaded-first,
        skipping ``exclude``; returns ``(name, PendingResult)`` or
        raises the front-door shed error. ``retry_of`` marks a
        reroute (journaled, counted)."""
        if rel_deadline is not None and rel_deadline <= 0:
            from ..serving import DeadlineExceeded
            raise DeadlineExceeded(
                "fleet deadline exhausted before a replica accepted")
        candidates = self._ranked(exclude or set())
        states: Dict[str, str] = {}
        errors: List[BaseException] = []
        for rep, health in candidates:
            states[rep.name] = health["state"]
            if not health["ready"]:
                continue
            try:
                inner = rep.server.submit(feed, deadline=rel_deadline)
            except (ServerOverloaded, CircuitOpen, ServerClosed) as e:
                errors.append(e)
                states[rep.name] = f"rejected:{type(e).__name__}"
                continue
            with self._lock:
                self._routed[rep.name] = self._routed.get(rep.name, 0) + 1
                if retry_of is not None:
                    self._counters["rerouted"] += 1
            if retry_of is not None:
                self.journal.emit("fleet.reroute", span=inner.span,
                                  inst=self.telemetry_inst,
                                  replica=rep.name, retry_of=retry_of)
            return rep.name, inner
        # nobody took it: shed with ONE typed front-door error
        with self._lock:
            self._counters["shed"] += 1
        self.journal.emit("fleet.shed", inst=self.telemetry_inst,
                          states=states)
        if errors and all(isinstance(e, ServerOverloaded) for e in errors):
            raise ServerOverloaded(
                sum(e.queue_depth for e in errors),
                sum(e.capacity for e in errors))
        if errors and all(isinstance(e, CircuitOpen) for e in errors):
            raise CircuitOpen(min(e.retry_after for e in errors))
        raise NoReplicaAvailable(states)

    def _probe(self, rep: _Replica) -> Dict[str, Any]:
        """One health probe, bounded by ``probe_timeout`` when set: the
        probe runs on a throwaway daemon thread that is ABANDONED at
        the bound (a probe that never returns — a wedged in-process
        ``health()``, a pathological adoptee — must not wedge routing
        or ``/healthz`` with it). A replica that declares
        ``probe_bounded`` (``RemoteReplica``: socket timeout + capped
        backoff retries + down-verdict cache) is probed INLINE — no
        thread per health check on the routing hot path."""
        if self.probe_timeout is None or \
                getattr(rep.server, "probe_bounded", False):
            return rep.server.health()
        box: Dict[str, Any] = {}

        def _go():
            try:
                box["h"] = rep.server.health()
            except BaseException as e:
                box["e"] = e

        t = threading.Thread(target=_go, daemon=True,
                             name=f"pdtorch-fleet-probe-{rep.name}")
        t.start()
        t.join(self.probe_timeout)
        if "h" in box:
            return box["h"]
        if "e" in box:
            raise box["e"]
        raise TimeoutError(
            f"health probe of replica {rep.name} did not return within "
            f"{self.probe_timeout}s (probe abandoned)")

    def _ranked(self, exclude: set) -> List[Tuple[_Replica, Dict[str, Any]]]:
        """Replicas with their health snapshots, least-loaded first
        (ready before not-ready; among ready ones probe-latency
        DEMOTION applies first — a slow-but-alive replica (health
        ``slow``, set by a remote proxy whose probe exceeded
        ``slow_after``) ranks after every healthy one but before the
        dead, graceful degradation instead of dead-or-alive; then
        load = queued + busy workers; ties broken round-robin so
        equal-load replicas share traffic)."""
        with self._lock:
            reps = [r for n, r in self._replicas.items() if n not in exclude]
            rr = self._rr
            self._rr += 1
        scored = []
        for i, rep in enumerate(reps):
            try:
                h = self._probe(rep)
            except Exception:  # a torn-down replica must not break routing
                h = {"ready": False, "live": False, "state": "unreachable",
                     "queue_depth": 0, "workers_busy": 0}
            load = h.get("queue_depth", 0) + h.get("workers_busy", 0)
            scored.append((not h.get("ready"), bool(h.get("slow")), load,
                           (i + rr) % max(len(reps), 1), rep, h))
        scored.sort(key=lambda s: s[:4])
        return [(rep, h) for *_, rep, h in scored]

    # -- rolling reload ------------------------------------------------------

    def reload(self, dirname: str) -> Dict[str, int]:
        """Rolling hot reload across the fleet: canary ONE replica
        (its reload runs the static preflight + golden-feed canary and
        rolls itself back on failure — a failed canary leaves every
        OTHER replica untouched), then fan out one replica at a time.
        A mid-rollout failure rolls every already-swapped replica back
        to the previous artifact before re-raising. Zero dropped
        in-flight requests across all replicas either way (each swap is
        the replica's own zero-drop reload). Returns
        ``{name: generation}`` after the rollout."""
        with self._reload_lock:
            with self._lock:
                reps = dict(self._replicas)
            probes = self._probe_all(reps)
            order = [r for n, r in reps.items()
                     if probes.get(n, {}).get("live")]
            if not order:
                raise ReloadFailed(dirname, "no live replica to reload")
            prev = self.dirname
            canary = order[0]
            self.journal.emit("fleet.reload_canary",
                              inst=self.telemetry_inst,
                              replica=canary.name, dirname=dirname)
            try:
                try:
                    canary.server.reload(dirname, block=True)
                except BaseException as e:
                    with self._lock:
                        self._counters["reload_failures"] += 1
                    self.journal.emit("fleet.reload",
                                      inst=self.telemetry_inst,
                                      dirname=dirname, ok=False,
                                      stage="canary",
                                      error=f"{type(e).__name__}: "
                                            f"{e}"[:300])
                    _log().warning(
                        "fleet reload of %s: canary %s rejected (%s) — "
                        "fleet untouched", dirname, canary.name, e)
                    # a connection-shaped canary failure (remote link
                    # died after the RELOAD left the socket) leaves the
                    # canary's generation unknown: best-effort roll it
                    # back so a swapped-then-partitioned canary does
                    # not serve the rejected artifact once healed —
                    # probing first, like _rollback, so a still-
                    # partitioned canary is skipped instead of wedging
                    # reload() for another reload_timeout
                    if prev is not None and isinstance(
                            e, (ConnectionError, OSError, TimeoutError)):
                        try:
                            self._probe(canary)
                            canary.server.reload(prev, block=True)
                        except BaseException as e2:
                            _log().error(
                                "rollback of canary %s to %s failed/"
                                "skipped: %s", canary.name, prev, e2)
                    raise
                swapped = [canary]
                for rep in order[1:]:
                    try:
                        rep.server.reload(dirname, block=True)
                    except BaseException as e:
                        # an in-process failure is typed and the
                        # replica provably did NOT swap; a connection-
                        # shaped failure (a partitioned remote, a reply
                        # lost after send) leaves the replica's state
                        # UNKNOWN — it may have swapped before the link
                        # died, so it joins the rollback (best-effort:
                        # still partitioned means still unreachable,
                        # logged, and the operator's replace() is the
                        # recovery — but a healed link rolls back here)
                        back = list(swapped)
                        if isinstance(e, (ConnectionError, OSError,
                                          TimeoutError)):
                            back.append(rep)
                        self._rollback(back, prev, dirname, e)
                        raise ReloadFailed(
                            dirname, f"replica {rep.name} failed "
                            f"mid-rollout ({type(e).__name__}: {e}); "
                            f"fleet rolled back to {prev!r}") from e
                    swapped.append(rep)
            finally:
                # every replica's reload (and a rollback's) is an
                # off-request-path load that moved the process-wide preparation
                # counter: re-pin the whole fleet so sibling loads never
                # read as request-path recompiles
                self._repin_all()
            self.dirname = dirname
            with self._lock:
                self._counters["reloads"] += 1
            self.journal.emit("fleet.reload", inst=self.telemetry_inst,
                              dirname=dirname, ok=True,
                              replicas=[r.name for r in swapped])
            return {r.name: r.server.generation for r in swapped}

    def _rollback(self, swapped: List[_Replica], prev: Optional[str],
                  dirname: str, cause: BaseException) -> None:
        with self._lock:
            self._counters["reload_failures"] += 1
            self._counters["reload_rollbacks"] += 1
        self.journal.emit("fleet.reload", inst=self.telemetry_inst,
                          dirname=dirname, ok=False, stage="rollout",
                          error=f"{type(cause).__name__}: {cause}"[:300],
                          rolling_back=[r.name for r in swapped])
        if prev is None:
            _log().error(
                "fleet reload of %s failed mid-rollout with no previous "
                "artifact on record: %d replica(s) left on the new model",
                dirname, len(swapped))
            return
        for rep in swapped:
            # a bounded probe first: rolling back an UNREACHABLE
            # replica (the partitioned one that just failed the
            # rollout) would stall the whole rollback for its reload
            # timeout — skip it, log it; replace()/a healed retry is
            # its recovery path
            try:
                self._probe(rep)
            except Exception as e:
                _log().error(
                    "rollback of replica %s to %s skipped: unreachable "
                    "(%s) — replace() it or retry once the link heals",
                    rep.name, prev, e)
                continue
            try:
                rep.server.reload(prev, block=True)
            except BaseException as e:  # pragma: no cover - best effort
                _log().error("rollback of replica %s to %s failed: %s",
                             rep.name, prev, e)

    # -- health + lifecycle --------------------------------------------------

    def _probe_all(self, reps: Dict[str, _Replica]) -> Dict[str, Dict]:
        """Health snapshots for a replica set. With ``probe_timeout``
        set the probes run CONCURRENTLY and the whole aggregation is
        bounded by ONE probe_timeout (not N of them): a probe that
        never returns is abandoned and its replica reported
        ``probe_timeout`` / unavailable — ``/healthz`` answers even
        while a replica is partitioned."""
        if self.probe_timeout is None:
            out: Dict[str, Dict] = {}
            for name, rep in reps.items():
                try:
                    out[name] = rep.server.health()
                except Exception as e:
                    out[name] = {"live": False, "ready": False,
                                 "state": f"unreachable:{type(e).__name__}"}
            return out
        results: Dict[str, Dict] = {}
        lock = threading.Lock()

        def _go(name, rep):
            try:
                h = rep.server.health()
            except Exception as e:
                h = {"live": False, "ready": False,
                     "state": f"unreachable:{type(e).__name__}"}
            with lock:
                results[name] = h

        threads = [threading.Thread(target=_go, args=(n, r), daemon=True,
                                    name=f"pdtorch-fleet-probe-{n}")
                   for n, r in reps.items()]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.probe_timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        with lock:
            out = dict(results)
        for name in reps:
            out.setdefault(name, {"live": False, "ready": False,
                                  "state": "probe_timeout"})
        return out

    def health(self) -> Dict[str, Any]:
        """Fleet readiness/liveness over the replicas' own state
        machines: ``ready`` (every replica ready) → ``degraded`` (some
        down, at least one ready — the fleet serves at reduced
        capacity) → ``unavailable`` (live replicas, none ready) →
        ``stopped``. Probes are bounded and concurrent when
        ``probe_timeout`` is set (see :meth:`_probe_all`) — a replica
        whose probe never returns is reported unavailable instead of
        wedging the aggregation."""
        with self._lock:
            reps = dict(self._replicas)
        health = self._probe_all(reps)
        live = [n for n, h in health.items() if h.get("live")]
        ready = [n for n, h in health.items() if h.get("ready")]
        if ready and len(ready) == len(health):
            state = "ready"
        elif ready:
            state = "degraded"
        elif live:
            state = "unavailable"
        else:
            state = "stopped"
        return {"state": state, "live": bool(live), "ready": bool(ready),
                "replicas": health, "replicas_live": len(live),
                "replicas_ready": len(ready),
                "queue_depth": sum(h.get("queue_depth", 0)
                                   for h in health.values())}

    def report(self) -> Dict[str, Any]:
        """Router counters + per-replica reports in one dict (the
        fleet mirror of ``PredictorServer.report()``)."""
        with self._lock:
            out: Dict[str, Any] = dict(self._counters)
            out["routed"] = dict(self._routed)
        health = self.health()
        out["health"] = health
        with self._lock:
            reps = dict(self._replicas)
        out["replicas"] = {}
        for n, r in reps.items():
            if not health["replicas"].get(n, {}).get("live"):
                continue
            try:
                out["replicas"][n] = r.server.report()
            except Exception:  # died between the probe and the report
                continue
        return out

    # -- journal shipping ----------------------------------------------------

    def ship_journals(self) -> int:
        """Pull every remote replica's NEW journal events over the
        framed control link and ingest them into this process's
        journal (``RunJournal.ingest`` — events keep their origin run
        id + seq and gain an ``origin`` field naming the replica), so
        one local ring/JSONL sink holds the fleet-wide timeline and
        ``RunJournal.recent(span=...)`` reads a request's full
        cross-process lifecycle. Incremental: per-replica high-water
        seq marks make repeated calls ship only what is new. Replicas
        without a journal wire (in-process ones share the journal
        already) and unreachable replicas are skipped. Returns the
        number of events ingested."""
        with self._lock:
            reps = dict(self._replicas)
        total = 0
        for name, rep in reps.items():
            fetch = getattr(rep.server, "journal_events", None)
            if fetch is None:
                continue
            with self._lock:
                since = self._journal_ship_seq.get(name, 0)
            try:
                events = fetch(since_seq=since)
            except Exception:  # partitioned/dead: ship on a later call
                continue
            if not events:
                continue
            high = max(int(e.get("seq", 0)) for e in events)
            total += self.journal.ingest(events, origin=name)
            with self._lock:
                self._journal_ship_seq[name] = max(
                    self._journal_ship_seq.get(name, 0), high)
        return total

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Close every replica (graceful drain by default) and the
        aggregated endpoint. Idempotent."""
        with self._lock:
            reps = list(self._replicas.values())
        for rep in reps:
            try:
                rep.server.close(drain=drain, timeout=timeout)
            except Exception:  # pragma: no cover - teardown best effort
                pass
        for agent in self._agents:
            try:
                agent.close()
            except Exception:
                pass
        if self._telemetry_server is not None:
            self._telemetry_server.close()
            self._telemetry_server = None
        from ..telemetry import get_registry
        get_registry().remove_collector(self._telemetry_cid)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    # -- aggregated telemetry ------------------------------------------------

    def _own_families(self):
        """The router's OWN series (``paddle_tpu_fleet_*``): routing/
        shed/retry counters + live/ready replica gauges. Registered as
        a process-registry collector; also merged into
        :meth:`metrics_families`."""
        from ..telemetry.registry import counter_family, gauge_family

        labels = {"inst": self.telemetry_inst}
        with self._lock:
            counters = dict(self._counters)
            routed = dict(self._routed)
        h = self.health()
        return [
            counter_family("paddle_tpu_fleet_submitted_total",
                           "Requests accepted at the fleet front door",
                           [(labels, counters["submitted"])]),
            counter_family("paddle_tpu_fleet_routed_total",
                           "Requests routed, by replica",
                           [({**labels, "replica": n}, v)
                            for n, v in sorted(routed.items())]),
            counter_family("paddle_tpu_fleet_rerouted_total",
                           "Never-dispatched requests resubmitted after a "
                           "replica death",
                           [(labels, counters["rerouted"])]),
            counter_family("paddle_tpu_fleet_shed_total",
                           "Requests shed at the front door",
                           [(labels, counters["shed"])]),
            counter_family("paddle_tpu_fleet_replicas_replaced_total",
                           "Replicas replaced after death",
                           [(labels, counters["replicas_replaced"])]),
            counter_family("paddle_tpu_fleet_replicas_grown_total",
                           "Replicas added by scale-up",
                           [(labels, counters["replicas_grown"])]),
            counter_family("paddle_tpu_fleet_replicas_retired_total",
                           "Replicas drained out by scale-down",
                           [(labels, counters["replicas_retired"])]),
            counter_family(
                "paddle_tpu_fleet_reloads_total",
                "Rolling reloads (by outcome)",
                [({**labels, "outcome": "ok"}, counters["reloads"]),
                 ({**labels, "outcome": "failed"},
                  counters["reload_failures"])]),
            counter_family("paddle_tpu_fleet_reload_rollbacks_total",
                           "Mid-rollout failures rolled back fleet-wide",
                           [(labels, counters["reload_rollbacks"])]),
            gauge_family("paddle_tpu_fleet_replicas_live",
                         "Replicas whose process is live",
                         [(labels, h["replicas_live"])]),
            gauge_family("paddle_tpu_fleet_replicas_ready",
                         "Replicas accepting traffic",
                         [(labels, h["replicas_ready"])]),
        ]

    def metrics_families(self):
        """The fleet-aggregated export: every replica's
        ``telemetry_families()`` merged under a ``replica`` label
        (:func:`paddle_tpu_torch.telemetry.merge_exports`) + the router's own
        ``paddle_tpu_fleet_*`` series (labeled ``replica="router"`` so
        the merged export has no unlabeled stragglers). Naming-
        convention clean by construction
        (``telemetry.validate_families`` — test-pinned)."""
        from ..telemetry.registry import merge_exports

        with self._lock:
            reps = dict(self._replicas)
        named = {"router": self._own_families()}
        for name, rep in reps.items():
            try:
                named[name] = rep.server.telemetry_families()
            except Exception:  # a dead replica exports nothing
                continue
        return merge_exports(named, label="replica")

    def serve_metrics(self, port: int = 0, host: Optional[str] = None):
        """The fleet-aggregated scrape endpoint: ``GET /metrics``
        (Prometheus text of :meth:`metrics_families`; ``?format=json``
        for the JSON snapshot) + ``GET /healthz`` (the fleet
        :meth:`health`, 503 once no replica is ready). One scrape
        covers every replica — the series differ only by ``replica``
        label. ``host`` defaults to ``PDTPU_BIND_ADDR`` (else
        loopback) so an off-host Prometheus can scrape it."""
        from ..telemetry import serve_metrics as _serve
        from ..telemetry.registry import FamiliesView

        if host is None:
            host = os.environ.get("PDTPU_BIND_ADDR") or "127.0.0.1"
        if self._telemetry_server is None:
            self._telemetry_server = _serve(
                registry=FamiliesView(self.metrics_families),
                health_fn=self.health, port=port, host=host)
        return self._telemetry_server

    def ship_to(self, addr, origin=None, **kw):
        """Attach THIS process's telemetry shipper to a collector at
        ``addr`` (``PDTPU_TELEMETRY_ADDR`` does the same with zero
        code). Remote replicas are separate processes — they ship on
        their own via the inherited env var; in-process replicas share
        this process's registry/journal and are covered by this one
        shipper. Returns the :class:`~paddle_tpu_torch.telemetry.shipper.
        Shipper`."""
        from ..telemetry.shipper import ship_to as _ship_to

        return _ship_to(addr, origin=origin, **kw)


__all__ = ["FleetPending", "FleetRouter", "NoReplicaAvailable"]
