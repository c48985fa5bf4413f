"""Fleet front door: proxy ``/v1/generate`` over remote peer gateways
(counterpart of ``paddle_tpu/serving/fleet/frontend.py``; reference:
the router/edge tier production LLM fleets put in front of N
model-server processes — an SSE-aware reverse proxy with
cache-affinity routing and mid-stream failover, restated stdlib-only
over the gateway's own HTTP surface).

:class:`FleetFrontend` turns N gateway PROCESSES into one service:

- **Routing** — the same :class:`~..router.PrefixAffinityRouter`
  ladder the in-process gateway uses, over :class:`~.remote
  .RemoteReplica` adapters (duck-typed seam: ``healthy``/``load``/
  ``has_prefix`` read cached HTTP-probe snapshots). Affinity keys are
  computed standalone (:func:`~.remote.prefix_digest_chain` — pinned
  byte-for-byte to the engine's digests), probed against each peer's
  GOSSIPED digest set, so the prefix cache is a fleet asset: a request
  lands on ANY warm peer.
- **Proxying** — the chosen peer's response is relayed BYTE-FOR-BYTE
  (status line, headers, every SSE event — pinned bitwise against a
  direct connection by test). Relaying parses events as they pass so
  the frontend always knows the committed ``(token, logprob)`` prefix
  of every in-flight stream.
- **Mid-stream failover** — a peer that dies mid-stream (connection
  drop, process kill, 5xx; the ``peer_conn_drop`` fault site injects
  it deterministically) routes the request through the same
  resume seam the in-process failover uses, now over HTTP:
  resubmit ``prompt + committed`` with ``resume_tokens``/
  ``resume_lps`` on a surviving peer, skip the re-emitted committed
  prefix when relaying, and the client sees no duplicated and no
  missing token — greedy streams finish BITWISE identical to an
  uninterrupted run (tokens AND logprobs); seeded sampled requests
  re-derive a per-hop seed (distribution-preserving, not bitwise —
  the contract, unchanged). ``failover_budget`` bounds the
  hops; a fully-committed-at-the-kill stream is synthesized from the
  committed prefix, never retried.
- **Federated live metrics** — ``GET /metricsz`` folds
  every peer's CACHED windowed telemetry doc (fetched on the probe
  rounds, staleness-bounded) into one fleet view: per-replica
  sections plus summed token/request rates, queue depth, worst
  goodput and the max SLO burn per class with every active alert
  tagged by peer — the "is the fleet healthy NOW" answer that used to
  take N manual scrapes and a join.
- **Rejoin** — a peer evicted by probe failures or a dropped stream
  carries a :class:`~..supervisor.CircuitBreaker`: after backoff the
  router hands it AT MOST ONE live probation probe; a proxied success
  closes the breaker and re-admits the peer (remote failures heal the
  same way local ones do).

The frontend is deliberately model-free: no engine, no torch — it can
run on a 2-vCPU edge box in front of a pod of accelerator hosts.
"""
from __future__ import annotations

import asyncio
import base64
import itertools
import json
import time
import uuid
from typing import Any, Dict, List, Optional

from ...utils import faults
from ...utils import observability as obs
from ..gateway import _SSE_HEAD  # noqa: F401  (re-export convenience)
from ..gateway import _http_response, _json_response, _query_param
from ..reqtrace import RequestTrace, RequestTraceRing
from ..router import NoReplicaError, PrefixAffinityRouter
from ..supervisor import BREAKER_CLOSED, CircuitBreaker
from .remote import RemoteReplica, prefix_digest_chain

__all__ = ["FleetFrontend"]

_frontend_ids = itertools.count()

# the per-hop seed fold for sampled requests, same constant the
# in-process failover uses (docs/FAULT_TOLERANCE.md §4b)
_SEED_FOLD = 0x9E3779B1


class _ProxyState:
    """Committed prefix of one proxied stream: exactly the (token,
    logprob) units FORWARDED to the client (a unit read off the peer
    but dropped by a fault/crash before forwarding is NOT committed —
    the client never saw it)."""

    __slots__ = ("tokens", "lps", "head_sent", "final", "t_first",
                 "migrated")

    def __init__(self):
        self.tokens: List[int] = []
        self.lps: List[Optional[float]] = []
        self.head_sent = False
        self.final: Optional[Dict[str, Any]] = None
        self.t_first: Optional[float] = None
        # the intercepted terminal "migrated" event of a draining peer:
        # committed stream + resume_kv digest, never
        # forwarded to the client
        self.migrated: Optional[Dict[str, Any]] = None


class FleetFrontend:
    """Serve ``/v1/generate`` over N remote peer gateways.

    ``peers``: list of :class:`RemoteReplica` (more can join at
    runtime via :meth:`add_peer` — the autoscaler's spawn path).
    ``chunk_tokens`` must match the peers' engines'
    ``chunk_prefill_tokens`` for affinity routing (None disables
    affinity: pure load balancing)."""

    def __init__(self, peers: List[RemoteReplica],
                 host: str = "127.0.0.1", port: int = 0, *,
                 chunk_tokens: Optional[int] = None,
                 routing: str = "prefix", spill_margin: float = 8.0,
                 failover_budget: int = 2,
                 peer_read_timeout_s: float = 30.0,
                 peer_connect_timeout_s: float = 5.0,
                 migrate: bool = True,
                 xfer_timeout_s: float = 2.0,
                 breakers: bool = True,
                 breaker_backoff_s: float = 1.0,
                 breaker_backoff_max_s: float = 30.0,
                 breaker_probes: int = 1,
                 name: Optional[str] = None,
                 trace: bool = True, trace_capacity: int = 512,
                 clock=time.monotonic):
        self.name = name or f"fleet{next(_frontend_ids)}"
        self.host, self.port = host, port
        self.chunk_tokens = chunk_tokens
        self._failover_budget = int(failover_budget)
        self._peer_read_timeout_s = float(peer_read_timeout_s)
        self._peer_connect_timeout_s = float(peer_connect_timeout_s)
        # cross-replica KV transfer: with migrate on, a
        # draining peer's migrated streams resubmit with an inline
        # resume_kv blob fetched over /kvz (bounded by xfer_timeout_s)
        # so the survivor restores instead of re-prefilling; off, the
        # same cutover just rides today's resume_tokens re-prefill.
        self._migrate = bool(migrate)
        self._xfer_timeout_s = float(xfer_timeout_s)
        self._breakers = bool(breakers)
        # the whole control plane is clock-injectable: the
        # fleet sim drives this frontend's breakers — and everything
        # downstream of them — on a simulated clock
        self._clock = clock
        self._breaker_kw = dict(backoff_s=breaker_backoff_s,
                                backoff_max_s=breaker_backoff_max_s,
                                probes_to_close=breaker_probes,
                                clock=clock)
        self._draining = False
        self._killed = False
        self._server: Optional[asyncio.AbstractServer] = None
        self._active = 0
        # live client writers, tracked so kill() can sever them
        # mid-stream (the in-process stand-in for a frontend SIGKILL)
        self._writers: set = set()
        self.peers: List[RemoteReplica] = []
        self._labels = {"gateway": self.name}
        reg = obs.registry()
        self._c_requests = reg.counter("fleet_requests_total",
                                       **self._labels)
        self._c_tokens = reg.counter("fleet_proxied_tokens_total",
                                     **self._labels)
        self._c_failovers = reg.counter("fleet_peer_failovers_total",
                                        **self._labels)
        self._c_exhausted = reg.counter(
            "fleet_retry_budget_exhausted_total", **self._labels)
        self._c_disconnects = reg.counter("fleet_disconnects_total",
                                          **self._labels)
        self._c_migrated = reg.counter("fleet_migrated_requests_total",
                                       **self._labels)
        self._g_replicas = reg.gauge("fleet_replicas", **self._labels)
        self._h_ttft = reg.histogram("fleet_ttft_ms",
                                     buckets=obs.SERVING_MS_BUCKETS,
                                     **self._labels)
        # start the router EMPTY: every peer joins through the one
        # membership path (add_peer — breaker attach + prober start)
        self._router = PrefixAffinityRouter(
            [], policy=routing, spill_margin=spill_margin,
            labels=self._labels)
        self.ring = RequestTraceRing(
            capacity=trace_capacity,
            labels=dict(self._labels, replica="frontend")) \
            if trace else None
        self.autoscaler = None      # attached via attach_autoscaler()
        for p in peers:
            self.add_peer(p)

    # --------------------------------------------------------- membership
    def add_peer(self, peer: RemoteReplica):
        """Join a peer (initial fleet, autoscaler spawn, rejoin):
        attach its breaker, start its prober, enter rotation."""
        if self._breakers and peer.breaker is None:
            peer.breaker = CircuitBreaker(
                on_state=self._breaker_state_cb(peer),
                **self._breaker_kw)
        self._router.add_replica(peer)
        if peer not in self.peers:
            self.peers.append(peer)
        peer.start()
        self._g_replicas.set(len(self.peers))
        obs.record_event("fleet_peer_join", fleet=self.name,
                         peer=peer.name)

    def remove_peer(self, peer: RemoteReplica):
        """Leave rotation (autoscaler drain / permanent death). The
        peer's prober stops; in-flight proxied streams to it finish on
        their own (a draining peer completes what it owns)."""
        self._router.remove_replica(peer)
        if peer in self.peers:
            self.peers.remove(peer)
        peer.stop()
        self._g_replicas.set(len(self.peers))
        obs.record_event("fleet_peer_leave", fleet=self.name,
                         peer=peer.name)

    def _breaker_state_cb(self, peer: RemoteReplica):
        def cb(state: str):
            if state == BREAKER_CLOSED:
                peer.mark(True)
            obs.record_event("fleet_breaker", fleet=self.name,
                             peer=peer.name, state=state)
        return cb

    def attach_autoscaler(self, scaler):
        self.autoscaler = scaler

    # ---------------------------------------------------------- lifecycle
    async def start(self):
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.autoscaler is not None:
            self.autoscaler.start()
        obs.record_event("fleet_start", fleet=self.name,
                         port=self.port, peers=len(self.peers))
        return self

    async def drain(self, timeout: float = 30.0):
        """Stop admitting, let in-flight proxies finish, stop the
        autoscaler and probers, close the listener."""
        self._draining = True
        if self.autoscaler is not None:
            self.autoscaler.stop()
        deadline = time.monotonic() + timeout
        while self._active > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        for p in list(self.peers):
            p.stop()
        if self._server is not None:
            self._server.close()
            try:
                await self._server.wait_closed()
            except Exception:
                pass
            self._server = None
        obs.record_event("fleet_drain", fleet=self.name)

    def kill(self):
        """In-process stand-in for ``SIGKILL`` of this frontend
        (HA tests): abort the listener and sever every live
        client stream mid-flight WITHOUT draining — in-flight requests
        die exactly as they would when the process dies, and clients
        must recover by retrying against a surviving sibling frontend
        with their committed prefix as ``resume_tokens``. Also stops
        the probers and the autoscaler so the corpse stops probing."""
        self._killed = True
        self._draining = True
        if self._server is not None:
            self._server.close()
            self._server = None
        for w in list(self._writers):
            try:
                w.transport.abort()
            except Exception:
                pass
        if self.autoscaler is not None:
            self.autoscaler.stop()
        for p in list(self.peers):
            p.stop()
        obs.record_event("fleet_kill", fleet=self.name)

    def dump_traces(self, directory: str) -> List[str]:
        """Write the frontend's own request-trace ring (the fleet's
        hop records — what ``trace_report``'s fleet merge joins with
        the peer gateways' rings by request id)."""
        import os
        if self.ring is None:
            return []
        os.makedirs(directory, exist_ok=True)
        return [self.ring.dump(os.path.join(
            directory, f"reqtrace_{self.name}_frontend.json"))]

    # ------------------------------------------------------------- health
    def healthz(self) -> Dict[str, Any]:
        return {
            "fleet": self.name,
            "draining": self._draining,
            "requests": int(self._c_requests.value),
            "proxied_tokens": int(self._c_tokens.value),
            "peer_failovers": int(self._c_failovers.value),
            "migrated_requests": int(self._c_migrated.value),
            "retry_budget_exhausted": int(self._c_exhausted.value),
            "disconnects": int(self._c_disconnects.value),
            "failover_budget": self._failover_budget,
            "router": self._router.snapshot(),
            "peers": {p.name: {"healthy": p.healthy(),
                               "load": p.load(),
                               "url": f"{p.host}:{p.port}"}
                      for p in self.peers},
        }

    def debugz(self) -> Dict[str, Any]:
        return {
            "fleet": self.name,
            "draining": self._draining,
            "router": self._router.snapshot(),
            "peers": {p.name: p.snapshot() for p in self.peers},
            "autoscaler": self.autoscaler.snapshot()
            if self.autoscaler is not None else None,
            "trace_ring": self.ring.summary()
            if self.ring is not None else None,
        }

    def metricsz(self, window_s: Optional[float] = None
                 ) -> Dict[str, Any]:
        """Federated ``GET /metricsz``: every peer's cached
        windowed doc under its own per-replica key, plus fleet totals
        (summed token/request rates, queue depth, worst goodput, max
        burn per SLO class, every active alert tagged with its peer).
        Reads ONLY the probe caches — no network on the serving path;
        a stale peer is excluded from totals, the same staleness bound
        routing applies. ``?window_s=N`` re-targets the probers' next
        rounds (cached federation converges within one interval)."""
        if window_s:
            for p in self.peers:
                p.set_metrics_window(window_s)
        replicas: Dict[str, Any] = {}
        tok_rate = req_rate = queue_depth = 0.0
        goodput_min: Optional[float] = None
        burn_max: Dict[str, float] = {}
        alerts_active: List[dict] = []
        live = 0
        for p in self.peers:
            mz = p.metricsz()
            replicas[p.name] = mz
            doc = mz.get("doc")
            if mz.get("stale") or not doc or not doc.get("enabled"):
                continue
            live += 1
            # fold ONLY the peer's own gateway="<name>" label variants:
            # a peer co-hosted with other gateways in one process (one
            # shared registry) samples THEIR series too, and summing
            # every variant would double-count the fleet totals
            own = doc.get("gateway")
            tag = f'gateway="{own}"' if own else None
            for full, view in (doc.get("metrics") or {}).items():
                if tag is not None and "{" in full and tag not in full:
                    continue
                base = full.split("{", 1)[0]
                if base == "gateway_tokens_total":
                    tok_rate += view.get("rate_per_s", 0.0)
                elif base == "gateway_requests_total":
                    req_rate += view.get("rate_per_s", 0.0)
                elif base == "gateway_queue_depth":
                    queue_depth += view.get("last", 0.0)
                elif base == "gateway_goodput_frac":
                    v = view.get("last", 1.0)
                    goodput_min = v if goodput_min is None \
                        else min(goodput_min, v)
            slo = doc.get("slo") or {}
            for cls, by_window in (slo.get("burn") or {}).items():
                for b in by_window.values():
                    if b > burn_max.get(cls, 0.0):
                        burn_max[cls] = b
            for a in slo.get("active") or ():
                alerts_active.append(dict(a, peer=p.name))
        return {
            "fleet": self.name,
            "enabled": True,
            "window_s": float(window_s) if window_s else None,
            "peers": len(self.peers),
            "live_peers": live,
            "replicas": replicas,
            "totals": {
                "tokens_per_sec": round(tok_rate, 3),
                "requests_per_sec": round(req_rate, 3),
                "queue_depth": queue_depth,
                "goodput_frac_min": goodput_min,
                "burn_rate_max": {k: round(v, 3)
                                  for k, v in burn_max.items()},
                "alerts_active": alerts_active,
            },
        }

    # ----------------------------------------------------- frontend HA
    def gossipz(self) -> Dict[str, Any]:
        """What a SIBLING frontend may adopt from us (leaderless
        HA; served at ``GET /gossipz`` over the same HTTP
        transport the probers already ride). Three kinds of state:

        - per-peer prefix digest sets + the PEER's generation counter
          (authoritative — comparable across frontends, so the fresher
          view always wins regardless of who probed last);
        - sticky routing assignments as ``{digest: peer name}`` (a
          sibling adopts only digests it has no opinion on);
        - health + breaker state per peer as HINTS only — every
          frontend re-derives liveness from its OWN probes (trusting a
          sibling's verdict would let one partitioned frontend blind
          the whole tier)."""
        return {
            "fleet": self.name,
            "draining": self._draining,
            "peers": {p.name: p.gossip_view() for p in self.peers},
            "sticky": self._router.export_sticky(),
        }

    # ---------------------------------------------------- profilez federation
    async def _serve_profilez(self, query: str, writer):
        """``GET /profilez?duration_s=N&replica=<peer>``:
        federate the gateway capture — one call on the frontend
        profiles a CHOSEN replica gateway (default: the first healthy
        peer). The blocking peer fetch runs in a thread so the capture
        window never stalls the frontend's event loop; the peer's own
        report is returned verbatim under ``report``."""
        dur = _query_param(query, "duration_s")
        dur = 1.0 if dur is None else max(0.05, min(float(dur), 30.0))
        want = _query_param(query, "replica", str)
        peer = None
        for p in self.peers:
            if want is not None:
                if p.name == want:
                    peer = p
                    break
            elif p.healthy():
                peer = p
                break
        if peer is None:
            writer.write(_json_response(
                404, {"error": f"no such replica {want!r}"
                      if want is not None else "no healthy peer"}))
            await writer.drain()
            return
        report = await asyncio.get_event_loop().run_in_executor(
            None, lambda: peer.fetch_profilez(dur))
        if report is None:
            writer.write(_json_response(
                502, {"error": f"peer {peer.name} capture failed"}))
        else:
            writer.write(_json_response(200, {
                "fleet": self.name, "replica": peer.name,
                "report": report}))
        await writer.drain()

    def apply_gossip(self, doc: Dict[str, Any]) -> Dict[str, int]:
        """Merge a sibling's :meth:`gossipz` doc. Only ever ADDS
        knowledge: digest sets move forward by generation guard,
        sticky entries fill local gaps, and nothing a local probe or
        route decision established is overridden. Unknown peer names
        are skipped — membership changes travel through the manager,
        not through gossip."""
        by_name = {p.name: p for p in self.peers}
        adopted_digests = 0
        for name, view in (doc.get("peers") or {}).items():
            peer = by_name.get(name)
            if peer is None or not isinstance(view, dict):
                continue
            if peer.adopt_digests(view.get("digests") or (),
                                  view.get("generation", -1),
                                  spilled=view.get("spilled") or ()):
                adopted_digests += 1
        adopted_sticky = self._router.merge_sticky(
            doc.get("sticky") or {}, by_name)
        if adopted_digests or adopted_sticky:
            obs.record_event("fleet_gossip_merge", fleet=self.name,
                             source=doc.get("fleet", "?"),
                             digest_sets=adopted_digests,
                             sticky=adopted_sticky)
        return {"digest_sets": adopted_digests,
                "sticky": adopted_sticky}

    # ---------------------------------------------------------------- HTTP
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        self._writers.add(writer)
        try:
            line = await asyncio.wait_for(reader.readline(), 30)
            parts = line.decode("latin1").split()
            if len(parts) < 3:
                return
            method, path = parts[0], parts[1]
            headers: Dict[str, str] = {}
            while True:
                h = await asyncio.wait_for(reader.readline(), 30)
                if h in (b"\r\n", b"\n", b""):
                    break
                k, _, v = h.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()
            try:
                n = int(headers.get("content-length", "0") or 0)
                if n < 0:
                    raise ValueError("negative")
            except ValueError:
                writer.write(_json_response(
                    400, {"error": "bad Content-Length"}))
                await writer.drain()
                return
            body = await asyncio.wait_for(reader.readexactly(n), 30) \
                if n else b""
            path, _, query = path.partition("?")
            path = path.rstrip("/") or "/"
            if method == "GET" and path == "/healthz":
                writer.write(_json_response(200, self.healthz()))
                await writer.drain()
            elif method == "GET" and path == "/debugz":
                writer.write(_json_response(200, self.debugz()))
                await writer.drain()
            elif method == "GET" and path == "/metricsz":
                window_s = _query_param(query, "window_s")
                writer.write(_json_response(
                    200, self.metricsz(window_s)))
                await writer.drain()
            elif method == "GET" and path == "/metrics":
                writer.write(_http_response(
                    200, obs.registry().prometheus_text().encode(),
                    ctype="text/plain; version=0.0.4"))
                await writer.drain()
            elif method == "GET" and path == "/gossipz":
                writer.write(_json_response(200, self.gossipz()))
                await writer.drain()
            elif method == "GET" and path == "/profilez":
                await self._serve_profilez(query, writer)
            elif method == "POST" and path == "/v1/generate":
                self._active += 1
                try:
                    await self._generate(body, headers, writer)
                finally:
                    self._active -= 1
            else:
                writer.write(_json_response(
                    404, {"error": f"no route {path}"}))
                await writer.drain()
        except (asyncio.IncompleteReadError, asyncio.TimeoutError,
                ConnectionError, OSError):
            pass
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    # ------------------------------------------------------------ generate
    async def _generate(self, body: bytes, headers: Dict[str, str],
                        writer: asyncio.StreamWriter):
        if self._draining:
            writer.write(_json_response(
                503, {"error": "draining: not admitting new requests"},
                extra={"Retry-After": "1"}))
            await writer.drain()
            return
        try:
            spec = json.loads(body.decode())
            if not isinstance(spec, dict):
                raise ValueError("request body must be a JSON object")
            ids = spec.get("prompt", spec.get("input_ids"))
            if not isinstance(ids, list) or not ids \
                    or not all(isinstance(t, int) for t in ids):
                raise ValueError("prompt must be a non-empty list of "
                                 "token ids")
        except ValueError as e:
            writer.write(_json_response(400, {"error": str(e)}))
            await writer.drain()
            return
        # one id across every hop and every process: body field wins,
        # then the inbound header, then a minted one — written back
        # into the proxied body so every peer's ring records the SAME
        # id (what the fleet trace merge joins on)
        rid = spec.get("request_id") \
            or headers.get("x-request-id") \
            or uuid.uuid4().hex[:16]
        spec = dict(spec, request_id=rid, prompt=list(ids))
        spec.pop("input_ids", None)
        self._c_requests.inc()
        trace = None
        if self.ring is not None:
            trace = RequestTrace(rid,
                                 tenant=str(spec.get("tenant",
                                                     "default")),
                                 slo=str(spec.get("slo",
                                                  "interactive")))
            trace.ev("accept", stream=bool(spec.get("stream", True)),
                     prompt_tokens=len(ids), fleet=self.name)
        digests = spec.get("affinity_key")
        if digests is None and self.chunk_tokens:
            # longest span first — the router's probe order
            digests = prefix_digest_chain(ids, self.chunk_tokens)[::-1]
        orig_prompt = list(ids)
        orig_max_new = int(spec.get("max_new_tokens", 32))
        orig_seed = spec.get("seed")
        st = _ProxyState()
        hops = 0
        t0 = time.monotonic()
        while True:
            meta: Dict[str, Any] = {}
            try:
                replica = self._router.route(
                    digests, trace=trace, allow_probe=hops == 0,
                    meta=meta)
            except NoReplicaError as e:
                await self._terminal_error(writer, st, trace, 503,
                                           str(e))
                return
            probe = meta.get("verdict") == "probe"
            if trace is not None:
                trace.ev("proxy_to", replica=replica.name,
                         attempt=hops)
            outcome = await self._proxy_stream(replica, spec, rid,
                                               writer, st, t0)
            if outcome == "done":
                final = st.final or {}
                reason = final.get("finish_reason",
                                   "error" if "error" in final
                                   else "stop")
                self._probe_done(replica, probe,
                                 True if reason == "stop" else None)
                if reason == "stop" and probe \
                        and replica.breaker is not None \
                        and replica.breaker.state == BREAKER_CLOSED \
                        and trace is not None:
                    trace.ev("breaker_close", replica=replica.name)
                self._finish_trace(trace, {
                    "stop": "stop", "timeout": "timeout",
                    "cancelled": "cancelled"}.get(reason, "error"),
                    st)
                return
            if outcome == "client_gone":
                self._c_disconnects.inc()
                self._probe_done(replica, probe, None)
                self._finish_trace(trace, "disconnect", st)
                return
            if outcome == "shed":
                # the peer shed with 429 (forwarded verbatim): the
                # fleet is overloaded, not broken — no eviction, no
                # budget charge, the client backs off
                self._probe_done(replica, probe, None)
                self._finish_trace(trace, "shed", st)
                return
            if outcome == "peer_shed":
                # a SURVIVOR shed a mid-stream failover resubmit:
                # overload, not failure — terminal for this request
                # (an SSE error event; the head is already out), but
                # the healthy peer is neither evicted nor charged
                self._probe_done(replica, probe, None)
                await self._terminal_error(
                    writer, st, trace, 503,
                    "failover resubmit shed: fleet overloaded",
                    outcome="shed")
                return
            # ------------------------------------ peer failed / migrated
            migrated = outcome == "peer_migrated"
            mig = (st.migrated or {}) if migrated else {}
            st.migrated = None
            resume_toks = list(st.tokens)
            resume_lps = list(st.lps)
            if migrated:
                # planned drain cutover: the peer is
                # draining, not broken — no eviction, no breaker
                # charge, but the hop still counts against the budget.
                # Adopt the event's committed stream when it extends
                # what we relayed (it includes tokens the peer held
                # back from emission): the skip-count dedupe forwards
                # the extension as the survivor re-emits it.
                self._probe_done(replica, probe, None)
                self._c_migrated.inc()
                # exclude the origin from the resubmit route NOW —
                # its healthz already answers draining:True but the
                # cached probe snapshot may not have observed it yet,
                # and a hop bounced off its 503 would both charge the
                # budget and drop the resume_kv we are about to attach
                replica.mark(False)
                toks = mig.get("tokens")
                if isinstance(toks, list) \
                        and len(toks) >= len(st.tokens) \
                        and [int(t) for t in
                             toks[:len(st.tokens)]] == st.tokens:
                    resume_toks = [int(t) for t in toks]
                    lps = mig.get("logprobs") or []
                    resume_lps = (list(lps) + [None] * len(toks)
                                  )[:len(toks)]
                if trace is not None:
                    trace.ev("peer_migrated", replica=replica.name,
                             committed=len(resume_toks),
                             resume_kv=str(mig.get("resume_kv")
                                           or "")[:12])
                obs.record_event("fleet_peer_migrated",
                                 fleet=self.name, peer=replica.name,
                                 request_id=rid,
                                 committed=len(resume_toks))
            else:
                self._c_failovers.inc()
                replica.note_proxy_failure()
                self._router.evict_unhealthy()
                self._probe_done(replica, probe, False)
                if trace is not None:
                    trace.ev("peer_fail", replica=replica.name,
                             reason=outcome)
                    if replica.breaker is not None:
                        trace.ev("breaker_open", replica=replica.name)
                obs.record_event("fleet_peer_fail", fleet=self.name,
                                 peer=replica.name, reason=outcome,
                                 request_id=rid)
            hops += 1
            remaining = orig_max_new - len(resume_toks)
            # checked BEFORE the retry budget (the rule): a
            # result the client already fully holds is never errored
            if resume_toks and remaining <= 0:
                # fully committed at the kill/cutover boundary:
                # forward any committed-but-unrelayed tail (tokens a
                # migrated event carried past what the peer streamed),
                # then synthesize the final event — never re-run or
                # 503 a complete result
                try:
                    for i in range(len(st.tokens), len(resume_toks)):
                        writer.write(b"data: " + json.dumps(
                            {"token": resume_toks[i],
                             "lp": resume_lps[i]}).encode() + b"\n\n")
                        self._c_tokens.inc()
                    st.tokens = list(resume_toks)
                    st.lps = list(resume_lps)
                    st.final = {"tokens": list(resume_toks),
                                "logprobs": [v for v in resume_lps],
                                "finish_reason": "stop", "done": True}
                    writer.write(b"data: "
                                 + json.dumps(st.final).encode()
                                 + b"\n\n")
                    await writer.drain()
                except (ConnectionError, OSError):
                    pass
                self._finish_trace(trace, "stop", st)
                return
            if hops > self._failover_budget:
                self._c_exhausted.inc()
                await self._terminal_error(
                    writer, st, trace, 503,
                    f"failover budget exhausted after "
                    f"{self._failover_budget} peer failures")
                return
            spec.pop("resume_kv", None)
            if resume_toks:
                # the HTTP face of the resume seam: re-prefill
                # prompt+committed on the survivor and skip the
                # re-emitted committed prefix while relaying
                spec = dict(spec,
                            prompt=orig_prompt + list(resume_toks),
                            resume_tokens=list(resume_toks),
                            resume_lps=list(resume_lps),
                            max_new_tokens=remaining)
                if migrated and self._migrate:
                    # resolve the migrated span to an inline
                    # wire blob the survivor injects — restore instead
                    # of re-prefill; any failure just leaves the
                    # re-prefill resume above (bitwise identical)
                    ref = await self._fetch_resume_kv(
                        replica, str(mig.get("resume_kv") or ""))
                    if ref:
                        spec = dict(spec, resume_kv=ref)
            if orig_seed is not None:
                # sampled streams re-derive a per-hop seed: the dead
                # peer consumed an unknown amount of the original
                # stream (distribution-preserving, not bitwise)
                spec = dict(spec,
                            seed=int(orig_seed) + _SEED_FOLD * hops)
            if trace is not None:
                trace.ev("resubmit", to_replica="", attempt=hops)
                trace.ev("resume_offset", offset=len(st.tokens),
                         committed=len(resume_toks))

    def _probe_done(self, replica, probe: bool,
                    success: Optional[bool]):
        if probe and replica.breaker is not None:
            replica.breaker.probe_done(success)

    def _finish_trace(self, trace, outcome: str, st: _ProxyState):
        if self.ring is not None and trace is not None:
            if st.t_first is not None:
                self._h_ttft.observe(
                    (st.t_first) * 1e3, exemplar=trace.request_id)
            self.ring.finish(trace, outcome, tokens=len(st.tokens))

    async def _terminal_error(self, writer, st: _ProxyState, trace,
                              status: int, msg: str,
                              outcome: str = "error"):
        try:
            if st.head_sent:
                writer.write(b"data: " + json.dumps(
                    {"error": msg, "done": True}).encode() + b"\n\n")
            else:
                writer.write(_json_response(
                    status, {"error": msg}, extra={"Retry-After": "1"}))
            await writer.drain()
        except (ConnectionError, OSError):
            pass
        self._finish_trace(trace, outcome, st)

    async def _fetch_resume_kv(self, origin: RemoteReplica,
                               digest: str) -> str:
        """Resolve a migrated span to an inline ``resume_kv`` blob
        (``b64:`` wire record) the survivor can inject without a
        fleet round-trip of its own. The drained origin is tried
        first — its arena provably holds the span and it keeps
        answering ``/kvz`` through the drain window — then any peer
        whose gossiped spilled tier claims the digest. Every failure
        (timeout, refused, corrupt, no digest) returns ``""``: the
        caller just resubmits on the re-prefill path, which is
        bitwise identical anyway."""
        if not digest:
            return ""
        cand = [origin] + [p for p in self.peers
                           if p is not origin and p.has_prefix(digest)]
        loop = asyncio.get_running_loop()
        for peer in cand:
            try:
                blob = await asyncio.wait_for(
                    loop.run_in_executor(
                        None, peer.fetch_kv, digest,
                        self._xfer_timeout_s),
                    self._xfer_timeout_s + 0.5)
            except (asyncio.TimeoutError, OSError, RuntimeError):
                continue
            if blob:
                return "b64:" + base64.b64encode(blob).decode("ascii")
        return ""

    # --------------------------------------------------------------- proxy
    async def _proxy_stream(self, replica: RemoteReplica,
                            spec: Dict[str, Any], rid: str,
                            writer: asyncio.StreamWriter,
                            st: _ProxyState, t0: float) -> str:
        """One proxy attempt against ``replica``. Returns ``"done"``
        (a terminal event/response was forwarded), ``"shed"`` (peer
        429, forwarded), ``"client_gone"``, or a peer-failure reason
        (``"peer_conn_drop"`` / ``"peer_error"`` / ``"peer_timeout"``
        — the caller runs the failover loop). Forwarding is
        byte-for-byte; the committed prefix in ``st`` advances only
        when a unit has actually been written to the client."""
        timeout = self._peer_read_timeout_s
        body = json.dumps(spec).encode()
        try:
            # bounded connect: a black-holed peer (SYN dropped) must
            # fail over in seconds, not the OS connect timeout —
            # peer_read_timeout_s only guards reads on an open conn
            pr, pw = await asyncio.wait_for(
                asyncio.open_connection(replica.host, replica.port),
                self._peer_connect_timeout_s)
        except (OSError, asyncio.TimeoutError):
            return "peer_error"
        try:
            pw.write((f"POST /v1/generate HTTP/1.1\r\n"
                      f"Host: {replica.host}\r\n"
                      f"X-Request-Id: {rid}\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode()
                     + body)
            await pw.drain()
            status_line = await asyncio.wait_for(pr.readline(), timeout)
            parts = status_line.split()
            if len(parts) < 2:
                return "peer_conn_drop"
            status = int(parts[1])
            head = status_line
            clen = 0
            sse = False
            while True:
                ln = await asyncio.wait_for(pr.readline(), timeout)
                if not ln:
                    return "peer_conn_drop"
                head += ln
                if ln in (b"\r\n", b"\n"):
                    break
                low = ln.lower()
                if low.startswith(b"content-length:"):
                    clen = int(ln.split(b":", 1)[1])
                if low.startswith(b"content-type:") \
                        and b"text/event-stream" in low:
                    sse = True
            if not sse:
                # one-shot JSON (nonstream, 4xx, 5xx): buffer, then
                # decide — forwarded verbatim or treated as a peer
                # failure the caller retries elsewhere
                payload = await asyncio.wait_for(
                    pr.readexactly(clen), timeout) if clen else b""
                if status >= 500:
                    return "peer_error"
                if st.head_sent:
                    # mid-SSE we cannot splice a fresh status line. A
                    # 429 from a survivor is OVERLOAD, not failure —
                    # terminal for this request (the rule:
                    # failover traffic is still sheddable, which is
                    # what stops a peer death amplifying into a retry
                    # storm) but never evicts or charges the budget;
                    # any other non-stream answer (peer restarted into
                    # draining, resume rejected) is a failed hop.
                    if status == 429:
                        return "peer_shed"
                    return "peer_error"
                try:
                    writer.write(head + payload)
                    await writer.drain()
                except (ConnectionError, OSError):
                    return "client_gone"
                if status == 429:
                    return "shed"
                st.final = {"finish_reason": "stop"} if status == 200 \
                    else {"error": f"peer status {status}",
                          "finish_reason": "error"}
                if status == 200:
                    try:
                        doc = json.loads(payload)
                        st.final = dict(doc,
                                        finish_reason=doc.get(
                                            "finish_reason", "stop"))
                        st.tokens = list(doc.get("tokens", ()))
                    except ValueError:
                        pass
                elif status == 504:
                    st.final = {"finish_reason": "timeout"}
                return "done"
            # ------------------------------------------------- SSE stream
            if not st.head_sent:
                try:
                    writer.write(head)
                    await writer.drain()
                except (ConnectionError, OSError):
                    return "client_gone"
                st.head_sent = True
            skip = len(st.tokens)   # survivor re-emits the committed
            seen = 0                # prefix first: drop, don't forward
            while True:
                try:
                    ln = await asyncio.wait_for(pr.readline(), timeout)
                except asyncio.TimeoutError:
                    return "peer_timeout"
                if not ln:
                    return "peer_conn_drop"
                unit = ln
                if ln.rstrip(b"\r\n"):
                    # data/comment line: its blank terminator belongs
                    # to the same unit — forward them together so the
                    # committed count only ever covers whole events
                    try:
                        nxt = await asyncio.wait_for(pr.readline(),
                                                     timeout)
                    except asyncio.TimeoutError:
                        return "peer_timeout"
                    if not nxt:
                        return "peer_conn_drop"
                    unit += nxt
                if not ln.startswith(b"data: "):
                    # SSE comment (half-close probe): relay verbatim
                    try:
                        writer.write(unit)
                        await writer.drain()
                    except (ConnectionError, OSError):
                        return "client_gone"
                    continue
                try:
                    ev = json.loads(ln[6:])
                except ValueError:
                    return "peer_error"
                if ev.get("done"):
                    if ev.get("finish_reason") == "migrated":
                        # planned drain cutover: NEVER
                        # forwarded — the caller resubmits to a
                        # survivor carrying the event's committed
                        # stream and resume_kv reference; the client
                        # just sees the stream continue
                        st.migrated = ev
                        return "peer_migrated"
                    if faults.inject("peer_conn_drop",
                                     replica=replica.name):
                        # severed between the last token and the done
                        # event — the fully-committed-at-the-kill case
                        return "peer_conn_drop"
                    try:
                        writer.write(unit)
                        await writer.drain()
                    except (ConnectionError, OSError):
                        return "client_gone"
                    st.final = ev
                    if isinstance(ev.get("tokens"), list):
                        st.tokens = list(ev["tokens"])
                    return "done"
                seen += 1
                if seen <= skip:
                    continue        # committed prefix replay: dedupe
                if faults.inject("frontend_conn_drop",
                                 frontend=self.name,
                                 replica=replica.name):
                    # the FRONTEND dies mid-stream (HA): the
                    # client's connection is severed with the unit
                    # unforwarded — the client holds only its committed
                    # prefix and must resume against a sibling frontend
                    try:
                        writer.transport.abort()
                    except Exception:
                        pass
                    return "client_gone"
                if faults.inject("peer_conn_drop",
                                 replica=replica.name):
                    # sever the peer leg BEFORE forwarding: the unit
                    # dies unseen, exactly like a real mid-wire kill
                    return "peer_conn_drop"
                try:
                    writer.write(unit)
                    await writer.drain()
                except (ConnectionError, OSError):
                    return "client_gone"
                if st.t_first is None:
                    st.t_first = time.monotonic() - t0
                st.tokens.append(int(ev["token"]))
                st.lps.append(ev.get("lp"))
                self._c_tokens.inc()
        except (asyncio.TimeoutError,):
            return "peer_timeout"
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            return "peer_conn_drop"
        finally:
            try:
                pw.close()
            except Exception:
                pass
