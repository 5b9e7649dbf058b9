"""The distributor service.

The hot regrouping loop (`requestsByTraceID` `distributor.go:694-801`)
becomes a vectorized pass: trace ids stack into an [n,16] uint8 matrix, ring
tokens come from one batched fnv hash (`token_for`), and replication sets
resolve with a single searchsorted per unique trace (ring.do_batch).

Counterpart of `tempo_tpu/distributor/distributor.py`, every route of
`push_otlp`: the decode-once staged tee (`_staging_plan`, `_push_staged`,
admission before staging), the columnar route (`_push_otlp_columnar`:
scan records or payload slices to in-process generators, payload slices
to remote ones) and the dict route (`push_spans`: attribute truncation,
forwarders, the ingest bus, the generator tee re-encoded to OTLP). The
port's native layer always builds (a failed build raises at import), so
the reference's numpy fallbacks for a missing native layer (`group_keys`
over a key matrix, the Python decoder behind `spans_from_otlp_proto_native`)
have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import errno
import random
import time
import urllib.error
from typing import Callable, Protocol, Sequence

import numpy as np

from tempo_tpu_torch.distributor.limiter import (IngestBackpressure, RateLimiter,
                                           effective_rate)
from tempo_tpu_torch.native import token_for   # native fnv batch
from tempo_tpu_torch.obs import Registry
from tempo_tpu_torch.overrides import Overrides
from tempo_tpu_torch.ring import InstanceDesc, Ring, do_batch
from tempo_tpu_torch.utils.livetraces import _approx_size

# discard reasons (mirroring the reference's discard metric reasons,
# `modules/distributor/distributor.go` reasonRateLimited etc.)
REASON_RATE_LIMITED = "rate_limited"
REASON_BACKPRESSURE = "sched_backpressure"
REASON_SAMPLED = "sampled"           # graceful-overload sampling (sampler.py)
REASON_TRACE_TOO_LARGE = "trace_too_large"
REASON_INVALID_TRACE_ID = "invalid_trace_id"
REASON_INTERNAL = "internal_error"
REASON_UNKNOWN_ERROR = "unknown_error"


def _never_committed(e: BaseException) -> bool:
    """True iff the failed generator-tee send provably never reached a
    listener (connection refused). ONLY those are safe to re-send to a
    re-resolved ring owner: timeouts / resets / client-level retry
    exhaustion may have committed server-side, and the inner
    RemoteGeneratorClient already retried them under ONE X-Push-Id —
    re-sending here would mint a new id past the receiver's dedupe."""
    if isinstance(e, urllib.error.URLError) and \
            not isinstance(e, urllib.error.HTTPError):
        e = e.reason if isinstance(e.reason, BaseException) else e
    return isinstance(e, ConnectionRefusedError) or (
        isinstance(e, OSError)
        and getattr(e, "errno", None) == errno.ECONNREFUSED)


class IngesterClient(Protocol):
    def push(self, tenant: str,
             traces: Sequence[tuple[bytes, list[dict]]]) -> list[str | None]: ...


class GeneratorClient(Protocol):
    # in-process implementations may set accepts_local_trust = True and
    # take push_otlp(..., trusted=True) for bytes validated in THIS
    # process; remote clients must not (their process re-validates)
    def push_otlp(self, tenant: str, data: bytes) -> int: ...


@dataclasses.dataclass
class DistributorConfig:
    rf: int = 3
    generator_rf: int = 1            # generator forwarding is RF1
    # generator-tee placement: "trace" spreads a tenant's spans over the
    # whole generator ring by trace token (the single-logical-generator
    # shape); "tenant" hashes the TENANT onto the ring so its entire
    # stream lands on the owning member — the fleet topology
    # (tempo_tpu_torch.fleet), where each member holds complete per-tenant
    # series/sketch state that can checkpoint and move
    generator_placement: str = "trace"
    # per-tenant forwarder configs: {tenant: [{name, endpoint, filter}, ...]}
    # (`modules/distributor/forwarder` per-tenant tee)
    forwarders: dict = dataclasses.field(default_factory=dict)
    # jaeger agent UDP receiver (thrift-compact emitBatch, port 6831 —
    # shim.go:165-171 jaeger protocols; deprecated upstream but still
    # deployed). 0 = disabled. EXPOSURE: the agent protocol is
    # unauthenticated single-tenant ingest, so the receiver binds
    # `jaeger_agent_host` (loopback by default); binding 0.0.0.0
    # additionally requires `jaeger_agent_allow_wildcard: true`.
    jaeger_agent_port: int = 0
    jaeger_agent_host: str = "127.0.0.1"
    jaeger_agent_allow_wildcard: bool = False


class RateLimited(RuntimeError):
    """Maps to gRPC ResourceExhausted + RetryInfo at the receiver shim
    (`modules/distributor/receiver/shim.go` RetryableError) and to 429 +
    Retry-After on the HTTP receivers. Raised for per-tenant rate limits
    AND for process-wide device-scheduler backpressure (`reason`
    distinguishes them; `retry_after_s` is advertised to the client)."""

    def __init__(self, tenant: str, n_bytes: int,
                 retry_after_s: float = 1.0,
                 reason: str = REASON_RATE_LIMITED):
        super().__init__(f"tenant {tenant} over ingestion rate ({n_bytes}B)"
                         if reason == REASON_RATE_LIMITED else
                         f"ingest backpressure: device scheduler saturated "
                         f"({n_bytes}B rejected)")
        self.tenant = tenant
        self.retry_after_s = retry_after_s
        self.reason = reason


class MalformedPayload(ValueError):
    """Decode-phase failure of a wire payload: the CLIENT's fault (HTTP
    400 / gRPC INVALID_ARGUMENT). Distinct from internal pipeline errors,
    which must surface as server faults, not as payload blame."""


class Distributor:
    def __init__(self,
                 ingester_ring: Ring,
                 ingester_clients: dict[str, IngesterClient],
                 overrides: Overrides | None = None,
                 generator_ring: Ring | None = None,
                 generator_clients: dict[str, GeneratorClient] | None = None,
                 cfg: DistributorConfig | None = None,
                 n_distributors: Callable[[], int] = lambda: 1,
                 bus: "object | None" = None,
                 registry: Registry | None = None,
                 now: Callable[[], float] = time.time) -> None:
        self.bus = bus
        self.cfg = cfg or DistributorConfig()
        self.overrides = overrides or Overrides()
        self.ingester_ring = ingester_ring
        self.ingester_clients = ingester_clients
        self.generator_ring = generator_ring
        self.generator_clients = generator_clients or {}
        self.limiter = RateLimiter(now=now)
        self.backpressure = IngestBackpressure()
        # graceful-overload sampling stage (runs on the staged decode-once
        # path BEFORE grouping/replication; see distributor/sampler.py) —
        # replaceable with one carrying an injected fraction_source
        from tempo_tpu_torch.distributor.sampler import SpanSampler
        self.sampler = SpanSampler(now=now)
        self.n_distributors = n_distributors
        from tempo_tpu_torch.distributor.forwarder import (
            Forwarder,
            ForwarderConfig,
            ForwarderManager,
        )
        from tempo_tpu_torch.utils.dataquality import DataQuality
        from tempo_tpu_torch.utils.usage import UsageTracker
        self.usage = UsageTracker()
        self.dataquality = DataQuality(now=now)
        # resource-bytes -> service.name memo (usage attribution): steady
        # traffic repeats the same few Resource messages every push
        self._svc_cache: dict[bytes, str] = {}
        self.forwarders = ForwarderManager()
        for tenant, fwd_cfgs in (self.cfg.forwarders or {}).items():
            for fc in fwd_cfgs:
                cfg_obj = fc if isinstance(fc, ForwarderConfig) \
                    else ForwarderConfig(**fc)
                self.forwarders.register(tenant, Forwarder(cfg_obj))
        # self-metrics (tempo_distributor_* naming): the plain dicts stay
        # the hot-path store; the obs registry renders them through
        # callback families registered below
        self.metrics: dict[str, float] = {
            "spans_received_total": 0, "bytes_received_total": 0,
            "traces_pushed_total": 0, "push_failures_total": 0,
            "push_retries_total": 0,
        }
        self.discarded: dict[str, int] = {}
        self.obs = registry if registry is not None else Registry()
        self._register_obs(self.obs)

    def _register_obs(self, reg: Registry) -> None:
        """This module's metric families — owned here, not scraped by the
        API layer."""
        helps = {
            "spans_received_total": "Spans accepted by the distributor",
            "bytes_received_total": "Wire bytes accepted by the distributor",
            "traces_pushed_total":
                "Distinct traces replicated to the ingester ring",
            "push_failures_total":
                "Quorum replication failures (ingester or generator ring)",
            "push_retries_total":
                "Tenant-placement generator pushes retried after a send "
                "failure (owner re-resolved off the live ring each "
                "attempt; the RPC push id makes the retry idempotent)",
        }
        for key, help_text in helps.items():
            reg.counter_func(
                f"tempo_distributor_{key}",
                lambda key=key: [((), self.metrics[key])], help=help_text)
        reg.counter_func(
            "tempo_discarded_spans_total",
            lambda: [((r,), v) for r, v in self.discarded.items()],
            help="Spans discarded by the distributor, by reason",
            labels=("reason",))
        reg.gauge_func(
            "tempo_distributor_sampling_keep_fraction",
            lambda: self.sampler.fractions(),
            help="Effective overload keep-fraction per tenant (1.0 = "
                 "sampling off; policy floor clamps the sched controller)",
            labels=("tenant",))
        reg.counter_func(
            "tempo_warnings_total",
            lambda: [((t, r), v) for (t, r), v in
                     self.dataquality.snapshot().items() if v],
            help="Data-quality warnings (clock skew, suspect timestamps)",
            labels=("tenant", "reason"))
        self.push_duration = reg.histogram(
            "tempo_distributor_push_duration_seconds",
            "End-to-end distributor push latency: validation, regrouping, "
            "ring replication, and the generator tee")

    # -- entry -------------------------------------------------------------

    def push_spans(self, tenant: str, spans: Sequence[dict],
                   size_bytes: int | None = None,
                   raw_otlp: bytes | None = None,
                   raw_recs: "np.ndarray | None" = None) -> dict[str, int]:
        """The PushTraces path (`distributor.go:398-488`): returns discard
        reason counts for partial failures; raises RateLimited when the
        tenant bucket is empty.

        `raw_otlp` is the original OTLP wire payload when the receiver had
        one (OTLP http/grpc); the generator tee then forwards raw byte
        slices instead of re-encoding (`sendToGenerators` ships proto, not
        dicts). `spans` must be in payload scan order in that case;
        `raw_recs` is the receiver's native SpanRec scan of the same bytes
        (passed along so the tee does not scan twice)."""
        from tempo_tpu_torch.utils import tracing
        t0 = time.perf_counter()
        try:
            with tracing.span_for_tenant("distributor.PushSpans", tenant,
                                         n_spans=len(spans)):
                return self._push_spans(tenant, spans, size_bytes, raw_otlp,
                                        raw_recs)
        finally:
            self.push_duration.observe(time.perf_counter() - t0)

    def push_otlp(self, tenant: str, raw: bytes,
                  recs: "np.ndarray | None" = None) -> dict[str, int]:
        """The COLUMNAR PushTraces path: raw OTLP wire bytes in, no span
        dicts anywhere in the distributor. The native scan's fixed columns
        drive vectorized validation, data-quality, usage attribution,
        trace grouping, and token hashing; replicas and the generator tee
        receive raw wire slices and unmarshal at THEIR end, exactly as the
        reference's ingesters unmarshal PushBytesV2 bodies. Falls back to
        the dict path whenever a feature needs per-span dicts (no native
        layer, attr truncation configured, non-service usage dimensions,
        or the ingest bus)."""
        from tempo_tpu_torch import native
        from tempo_tpu_torch.utils import tracing

        lim = self.overrides.for_tenant(tenant)
        # config gates first: a fallback tenant must pay ONE decode, not
        # a columnar scan plus a dict decode
        needs_dicts = (lim.ingestion.max_attribute_bytes
                       or self.bus is not None
                       or not self.forwarders.empty
                       or set(self.usage.cfg.dimensions) - {"service"})
        if not needs_dicts:
            # decode-once staged tee: when EVERY ring target can consume
            # row views over one shared columnar staging, the payload is
            # decoded exactly once and never re-sliced or re-encoded
            plan = self._staging_plan(tenant, lim)
            if plan is not None:
                from tempo_tpu_torch.model.otlp_batch import stage_otlp

                # admission BEFORE staging: a rejected push must not
                # intern its strings into the tenant registry's interner
                # (unbounded growth under sustained 429s) nor pay the
                # full decode during exactly the stall backpressure
                # sheds. Rejected span counts come from a lazy cheap
                # NON-interning scan — only a rejection pays it. (A
                # payload that then fails staging has already debited
                # the bucket; malformed input spending the sender's own
                # rate budget is an acceptable divergence.)
                def _count_spans() -> int:
                    try:
                        return len(native.otlp_scan(raw))
                    except ValueError:
                        return 0

                self._admit(tenant, lim, len(raw), _count_spans)
                interner, need_span, need_res = plan
                try:
                    staged = stage_otlp(raw, interner,
                                        include_span_attrs=need_span,
                                        include_res_attrs=need_res)
                except ValueError as e:
                    raise MalformedPayload(str(e)) from None
                t0 = time.perf_counter()
                try:
                    with tracing.span_for_tenant(
                            "distributor.PushSpans", tenant,
                            n_spans=staged.n):
                        return self._push_staged(tenant, raw, staged, lim)
                finally:
                    self.push_duration.observe(time.perf_counter() - t0)
            if recs is None:
                try:
                    recs = native.otlp_scan(raw)
                except ValueError as e:
                    raise MalformedPayload(str(e)) from None
            t0 = time.perf_counter()
            try:
                with tracing.span_for_tenant("distributor.PushSpans",
                                             tenant, n_spans=len(recs)):
                    return self._push_otlp_columnar(tenant, raw, recs, lim)
            finally:
                self.push_duration.observe(time.perf_counter() - t0)
        try:
            spans, recs2 = native.spans_from_otlp_proto_native(
                raw, return_recs=True)
        except ValueError as e:
            raise MalformedPayload(str(e)) from None
        return self.push_spans(tenant, spans, size_bytes=len(raw),
                               raw_otlp=raw, raw_recs=recs2)

    def _admit(self, tenant: str, lim, sz: int, n_spans) -> None:
        """Admission shared by every push path: process-wide backpressure
        BEFORE the tenant token bucket — a shed push must not debit the
        tenant's rate budget, or retries during a device stall would
        exhaust the bucket and misreport the 429 cause as rate_limited
        long after the scheduler recovers. `n_spans` may be a lazy
        callable: the staged route attributes rejected span counts from a
        cheap non-interning scan only when a rejection actually happens."""
        retry = self.backpressure.retry_after()
        if retry is not None:
            self._discard(REASON_BACKPRESSURE,
                          n_spans() if callable(n_spans) else n_spans)
            raise RateLimited(tenant, sz, retry_after_s=retry,
                              reason=REASON_BACKPRESSURE)
        rate = effective_rate(lim.ingestion.rate_strategy,
                              lim.ingestion.rate_limit_bytes,
                              self.n_distributors())
        if not self.limiter.allow(tenant, sz, rate,
                                  lim.ingestion.burst_size_bytes):
            self._discard(REASON_RATE_LIMITED,
                          n_spans() if callable(n_spans) else n_spans)
            raise RateLimited(tenant, sz)

    def _service_cached(self, raw: bytes, off: int, ln: int) -> str:
        """Memoized `_resource_service` keyed by the resource BYTES."""
        key = raw[off:off + ln] if ln > 0 else b""
        got = self._svc_cache.get(key)
        if got is None:
            if len(self._svc_cache) >= 4096:
                self._svc_cache.clear()
            got = self._svc_cache[key] = _resource_service(raw, off, ln)
        return got

    def _push_otlp_columnar(self, tenant: str, raw: bytes,
                            recs: np.ndarray, lim) -> dict[str, int]:
        n = len(recs)
        sz = len(raw)
        self._admit(tenant, lim, sz, n)
        self.metrics["spans_received_total"] += n
        self.metrics["bytes_received_total"] += sz
        self.dataquality.observe_start_ns(tenant, recs["start_ns"])

        # usage attribution by service: scan records arrive grouped by
        # ResourceSpans, so each distinct res_off is ONE contiguous run —
        # run detection replaces the sorting np.unique, and the resource
        # parse is memoized on the resource BYTES (payload shapes repeat
        # push to push; same attributed result, no per-push re-parse)
        if n and self.usage.cfg.dimensions == ("service",):
            ro = recs["res_off"]
            change = np.empty(n, bool)
            change[0] = True
            np.not_equal(ro[1:], ro[:-1], out=change[1:])
            first_r = np.flatnonzero(change)
            run_lens = np.diff(np.append(first_r, n))
            # even split of the wire size, matching observe(size_bytes=..)
            # so path choice cannot shift a tenant's attributed bytes
            per_span = sz / max(n, 1)
            self.usage.observe_grouped(tenant, [
                ((self._service_cached(raw, int(ro[i]),
                                       int(recs["res_len"][i])),),
                 int(c), float(c) * per_span)
                for i, c in zip(first_r.tolist(), run_lens.tolist())])

        # validation: vectorized trace-id check (pkg/validation)
        errs: dict[str, int] = {}
        valid = (recs["tid_len"] > 0) & (recs["tid_len"] <= 16)
        n_bad = int(n - valid.sum())
        if n_bad:
            errs[REASON_INVALID_TRACE_ID] = n_bad
            self._discard(REASON_INVALID_TRACE_ID, n_bad)
        if not valid.any():
            return errs

        # regroup by trace: one native hash pass over (padded 16-byte id ‖
        # wire length) — the length disambiguates a short id from the
        # 16-byte id that shares its zero-padded form (the dict path keys
        # on exact bytes). `requestsByTraceID` distributor.go:694 without
        # the O(n log n) sort numpy's void unique would pay — and read
        # straight from the records, skipping the key-matrix copies.
        from tempo_tpu_torch import native as _native

        vrows = np.flatnonzero(valid)
        first, inverse = _native.group_keys_recs(recs, valid)
        uniq_mat = np.ascontiguousarray(recs["trace_id"][vrows[first]])
        uniq_len = recs["tid_len"][vrows[first]]
        tokens = token_for(tenant, uniq_mat)
        n_traces = len(first)

        from tempo_tpu_torch.model.otlp import slice_otlp_payload

        def payload_for(items: list[int]) -> bytes:
            if len(items) == n_traces and len(vrows) == len(recs):
                # full coverage AND nothing failed validation — only then
                # is the raw payload the correct slice
                return raw
            pick = np.zeros(n_traces, bool)
            pick[np.asarray(items, np.int64)] = True
            wis = vrows[pick[inverse]]       # O(n) gather, no isin sort
            if len(wis) == len(recs):
                return raw
            return slice_otlp_payload(raw, recs, wis.tolist())

        # replicate to ingesters (RF quorum, per-trace reason dedupe)
        ring = self.ingester_ring
        if lim.ingestion.tenant_shard_size:
            ring = ring.shuffle_shard(tenant, lim.ingestion.tenant_shard_size)
        item_reason: dict[int, str] = {}
        # keyed by (padded hex, wire length): replicas reply with exact
        # wire bytes, scan records pad — normalize without merging ids
        # that differ only in trailing-zero padding. Built LAZILY: the
        # happy path (no per-trace errors) never pays the n_traces
        # tobytes+hex loop that showed up in the tee-path profile.
        tid_to_item: dict = {}

        def _item_of(tid_hex: str) -> "int | None":
            if not tid_to_item:
                tid_to_item.update(
                    {(uniq_mat[i].tobytes().hex(), int(uniq_len[i])): i
                     for i in range(n_traces)})
            return tid_to_item.get((tid_hex.ljust(32, "0"),
                                    len(tid_hex) // 2))

        def send_ing(inst: InstanceDesc, items: list[int]) -> None:
            client = self.ingester_clients[inst.id]
            fn = getattr(client, "push_otlp", None)
            if fn is not None:
                for tid_hex, reason in (fn(tenant, payload_for(items))
                                        or {}).items():
                    i = _item_of(tid_hex)
                    if i is not None and reason:
                        item_reason.setdefault(i, reason)
                return
            # client without the OTLP seam: decode just its slice
            from tempo_tpu_torch.model.otlp import spans_from_otlp_proto
            spans = list(spans_from_otlp_proto(payload_for(items)))
            groups: dict[bytes, list] = {}
            for s in spans:
                groups.setdefault(s["trace_id"], []).append(s)
            res = client.push(tenant, list(groups.items()))
            for (tid, _g), reason in zip(groups.items(), res or ()):
                if reason:
                    i = _item_of(tid.hex())
                    if i is not None:
                        item_reason.setdefault(i, reason)

        try:
            do_batch(ring, tokens, list(range(n_traces)), send_ing,
                     rf=self.cfg.rf)
            self.metrics["traces_pushed_total"] += n_traces
        except RuntimeError:
            self.metrics["push_failures_total"] += 1
            nv = int(valid.sum())
            self._discard(REASON_INTERNAL, nv)
            errs[REASON_INTERNAL] = errs.get(REASON_INTERNAL, 0) + nv
        for reason in item_reason.values():
            errs[reason] = errs.get(reason, 0) + 1
            self._discard(reason, 1)

        # generator tee (RF1, best-effort, raw slices)
        if self.generator_ring is not None and self.generator_clients \
                and lim.generator.processors:
            def recs_for(items: list[int]) -> np.ndarray:
                if len(items) == n_traces and len(vrows) == len(recs):
                    return recs
                pick = np.zeros(n_traces, bool)
                pick[np.asarray(items, np.int64)] = True
                return recs[vrows[pick[inverse]]]

            def send_gen(inst: InstanceDesc, items: list[int]) -> None:
                client = self.generator_clients[inst.id]
                if getattr(client, "accepts_local_trust", False):
                    # in-process generator (explicit marker — never
                    # inferred): these bytes already passed this process's
                    # scan validation, so the stage may trust them. Remote
                    # clients re-validate at their own process boundary.
                    # Fastest route: hand over the scan RECORDS (subset
                    # for sharded tees) + the original payload — the
                    # generator resolves without re-parsing or slicing.
                    fn = getattr(client, "push_otlp_recs", None)
                    if fn is not None and \
                            fn(tenant, raw, recs_for(items)) is not None:
                        return
                    client.push_otlp(tenant, payload_for(items),
                                     trusted=True)
                else:
                    client.push_otlp(tenant, payload_for(items))

            self._send_generator_tee(tenant, tokens, n_traces, send_gen)
        return errs

    def _send_generator_tee(self, tenant: str, tokens: np.ndarray,
                            n_items: int, send_fn) -> None:
        """Route one generator-tee batch; failures count, never raise.

        Default placement ("trace"): per-trace tokens spread one tenant
        over the whole ring via `do_batch`. Fleet mode ("tenant"): the
        WHOLE batch goes to the tenant's single ring owner resolved with
        `Ring.owner_of` — the same hash AND the same health-spillover
        walk the fleet ownership watch uses, so routing and checkpoint
        placement agree even while a member is dead-but-registered
        (heartbeat expiry with no leave()): `do_batch`'s replica walk
        does not skip unhealthy instances, which would black-hole the
        dead member's tenants until its descriptor was removed."""
        from tempo_tpu_torch.utils import tracing

        if self.cfg.generator_placement == "tenant":
            from tempo_tpu_torch.fleet.placement import tenant_token

            # owner-moved retry: a REFUSED send (dead/killed member, the
            # one failure that provably never committed) re-resolves the
            # owner off the LIVE ring view — heartbeat expiry or handoff
            # may have moved the tenant mid-push — and retries with
            # jitter. Ambiguous failures stay failures: the client-level
            # idempotent retry (same X-Push-Id) already covered them.
            # ONE tee span for the whole walk (like the RPC client's
            # one-span retry loop): owner moves widen it, never fork it.
            with tracing.span_for_tenant("distributor.GeneratorTee",
                                         tenant, n_items=n_items) as sp:
                last_owner = None
                for attempt in range(3):
                    inst = self.generator_ring.owner_of(
                        tenant_token(tenant))
                    if inst is None:
                        break
                    if sp is not None:
                        sp.attrs["owner"] = inst.id
                    try:
                        send_fn(inst, list(range(n_items)))
                        return
                    except Exception as e:
                        if attempt == 2 or not _never_committed(e):
                            break
                        if last_owner == inst.id:
                            # same owner still refusing: brief jittered
                            # pause before the ring view names a new one
                            time.sleep(0.05 * (1 + attempt)
                                       * (0.5 + random.random()))
                        last_owner = inst.id
                        self.metrics["push_retries_total"] += 1
                self.metrics["push_failures_total"] += 1
                if sp is not None:
                    sp.status_code = 2
                    sp.attrs["error.message"] = "generator tee failed"
            return
        try:
            with tracing.span_for_tenant("distributor.GeneratorTee",
                                         tenant, n_items=n_items):
                do_batch(self.generator_ring, tokens,
                         list(range(n_items)), send_fn,
                         rf=self.cfg.generator_rf)
        except RuntimeError:
            self.metrics["push_failures_total"] += 1

    # -- decode-once staged tee --------------------------------------------

    def _staging_plan(self, tenant: str, lim
                      ) -> "tuple[object, bool, bool] | None":
        """(interner, need_span_attrs, need_res_attrs) when the staged tee
        can serve this push, else None (columnar byte-slice route).

        Eligible only when every generator client is an IN-PROCESS staged
        consumer (`staging_profile` — staging must share the tenant
        registry's interner) agreeing on ONE interner, and every ingester
        client accepts staged views. Remote clients unmarshal at their own
        process boundary, exactly as before."""
        if self.generator_ring is None or not self.generator_clients \
                or not lim.generator.processors:
            return None
        # ring-KV deployments hand us a live client POOL, not a dict —
        # those clients are remote by construction, so the staged tee
        # (an in-process seam) never applies
        if not hasattr(self.generator_clients, "values") \
                or not hasattr(self.ingester_clients, "values"):
            return None
        interner = None
        need_span = need_res = False
        for client in self.generator_clients.values():
            if not getattr(client, "accepts_local_trust", False) \
                    or getattr(client, "push_staged_view", None) is None:
                return None
            prof = getattr(client, "staging_profile", None)
            if prof is None:
                return None
            it, ns, nr = prof(tenant)
            if interner is None:
                interner = it
            elif it is not interner:
                # distinct in-process generators with distinct id spaces:
                # one shared staging cannot serve both
                return None
            need_span |= ns
            need_res |= nr
        for client in self.ingester_clients.values():
            if getattr(client, "push_staged", None) is None:
                return None
            if getattr(client, "staged_needs_attrs", True):
                # persisting ingesters need the attr columns in the
                # staging (the block schema keeps them)
                need_span = need_res = True
        return interner, need_span, need_res

    def _push_staged(self, tenant: str, raw: bytes, staged,
                     lim) -> dict[str, int]:
        """The decode-once write path: ONE staging pass produced `staged`;
        validation, data quality, usage attribution, trace grouping, and
        token hashing all read the staged columns, and every ring target
        receives a row-index VIEW over the same arrays — no re-slicing,
        no re-encoding, no second decode anywhere in the process.
        Admission (`_admit`) already ran in the caller, BEFORE staging."""
        recs = staged.spans
        n = staged.n
        sz = len(raw)
        self.metrics["spans_received_total"] += n
        self.metrics["bytes_received_total"] += sz
        self.dataquality.observe_start_ns(tenant, recs["start_ns"])

        # usage attribution by service: staged records arrive grouped by
        # resource, so res_idx changes delimit runs; the staged
        # service_id column (fixup applied) replaces the resource-bytes
        # memo parse entirely
        if n and self.usage.cfg.dimensions == ("service",):
            ri = recs["res_idx"]
            change = np.empty(n, bool)
            change[0] = True
            np.not_equal(ri[1:], ri[:-1], out=change[1:])
            first_r = np.flatnonzero(change)
            run_lens = np.diff(np.append(first_r, n))
            svc_ids = staged.service_ids()
            it = staged.interner
            per_span = sz / max(n, 1)
            self.usage.observe_grouped(tenant, [
                ((it.lookup(int(svc_ids[int(ri[i])]))
                  if len(svc_ids) else "",),
                 int(c), float(c) * per_span)
                for i, c in zip(first_r.tolist(), run_lens.tolist())])

        # validation: vectorized trace-id check
        errs: dict[str, int] = {}
        valid = (recs["tid_len"] > 0) & (recs["tid_len"] <= 16)
        n_bad = int(n - valid.sum())
        if n_bad:
            errs[REASON_INVALID_TRACE_ID] = n_bad
            self._discard(REASON_INVALID_TRACE_ID, n_bad)
        if not valid.any():
            return errs

        # graceful-overload sampling stage (sampler.py): under rising
        # sched pressure the keep-fraction drops below 1.0 and spans are
        # hash-sampled HERE — before grouping, replication, and the tee —
        # so every target shares one decision through the row views.
        # Error/latency-tail spans are always kept; kept spans carry
        # Horvitz-Thompson weights the generator uses to upscale rates.
        # At fraction 1.0 (no pressure / tenant opt-out) this whole block
        # is a no-op and the path is bit-identical to pre-sampling.
        pol = lim.sampling
        dur_s = None
        if pol.enabled and pol.tail_quantile > 0:
            # warm the tail sketch only for tenants whose policy reads
            # it — an opted-out tenant pays nothing on the hot path;
            # the durations pass is shared with sample() below
            dur_s = self.sampler.durations_s(recs)
            self.sampler.observe(tenant, recs, dur_s=dur_s)
        frac = self.sampler.effective_fraction(tenant, pol)
        if frac < 1.0:
            keep, weights = self.sampler.sample(tenant, recs, valid, frac,
                                                pol, dur_s=dur_s)
            n_drop = int((valid & ~keep).sum())
            if n_drop:
                self._discard(REASON_SAMPLED, n_drop)
            valid = valid & keep
            staged.sample_weight = weights
            # sampled spans are an intentional degradation, not a client
            # error: the push succeeds and errs stays clean (a retry
            # would re-offer bytes the process just chose to shed)
            if not valid.any():
                return errs

        # regroup by trace over the staged id columns (id ‖ wire length,
        # as the columnar path keys) — straight off the StageRec rows
        from tempo_tpu_torch import native as _native

        vrows = np.flatnonzero(valid)
        first, inverse = _native.group_keys_strided(recs, valid)
        uniq_mat = np.ascontiguousarray(recs["trace_id"][vrows[first]])
        uniq_len = recs["tid_len"][vrows[first]]
        tokens = token_for(tenant, uniq_mat)
        n_traces = len(first)

        def rows_for(items: list[int]) -> np.ndarray:
            if len(items) == n_traces:
                return vrows
            pick = np.zeros(n_traces, bool)
            pick[np.asarray(items, np.int64)] = True
            return vrows[pick[inverse]]

        ring = self.ingester_ring
        if lim.ingestion.tenant_shard_size:
            ring = ring.shuffle_shard(tenant, lim.ingestion.tenant_shard_size)
        item_reason: dict[int, str] = {}
        tid_to_item: dict = {}

        def _item_of(tid_hex: str) -> "int | None":
            if not tid_to_item:
                tid_to_item.update(
                    {(uniq_mat[i].tobytes().hex(), int(uniq_len[i])): i
                     for i in range(n_traces)})
            return tid_to_item.get((tid_hex.ljust(32, "0"),
                                    len(tid_hex) // 2))

        def send_ing(inst: InstanceDesc, items: list[int]) -> None:
            client = self.ingester_clients[inst.id]
            got = client.push_staged(tenant, staged.view(rows_for(items)))
            for tid_hex, reason in (got or {}).items():
                i = _item_of(tid_hex)
                if i is not None and reason:
                    item_reason.setdefault(i, reason)

        try:
            do_batch(ring, tokens, list(range(n_traces)), send_ing,
                     rf=self.cfg.rf)
            self.metrics["traces_pushed_total"] += n_traces
        except RuntimeError:
            self.metrics["push_failures_total"] += 1
            nv = int(valid.sum())
            self._discard(REASON_INTERNAL, nv)
            errs[REASON_INTERNAL] = errs.get(REASON_INTERNAL, 0) + nv
        for reason in item_reason.values():
            errs[reason] = errs.get(reason, 0) + 1
            self._discard(reason, 1)

        # generator tee (RF1, best-effort, staged views)
        def send_gen(inst: InstanceDesc, items: list[int]) -> None:
            client = self.generator_clients[inst.id]
            view = staged.view(rows_for(items))
            if client.push_staged_view(tenant, view) is not None:
                return
            # declined (e.g. the tenant instance was rebuilt with a fresh
            # interner between planning and send): compatibility fallback
            # through the OTLP-bytes surface. The bytes surface has no
            # weight channel, so a SAMPLED push falls back un-upscaled —
            # rare (one race window per instance rebuild), but it must
            # not be silent: that window's rates read low.
            if staged.sample_weight is not None:
                import logging
                logging.getLogger("tempo_tpu_torch.ingest").warning(
                    "staged tee declined for tenant %s during sampling: "
                    "falling back to bytes, sample weights dropped "
                    "(rates under-reported for this push)", tenant)
            if view.is_full:
                client.push_otlp(tenant, raw, trusted=True)
            elif staged.has_span_attrs:
                from tempo_tpu_torch.model.otlp import encode_spans_otlp
                client.push_otlp(tenant,
                                 encode_spans_otlp(view.to_span_dicts()))
            else:
                # staged without span attrs (every ingester opted out):
                # dict re-encode would silently drop attributes — slice
                # the raw payload instead (scan rows align with staged
                # rows: both scans emit in payload order)
                from tempo_tpu_torch import native
                from tempo_tpu_torch.model.otlp import slice_otlp_payload
                recs2 = native.otlp_scan(raw)
                client.push_otlp(
                    tenant,
                    slice_otlp_payload(raw, recs2,
                                       view.row_indices().tolist()),
                    trusted=True)

        self._send_generator_tee(tenant, tokens, n_traces, send_gen)
        return errs

    def _push_spans(self, tenant, spans, size_bytes, raw_otlp,
                    raw_recs) -> dict[str, int]:
        lim = self.overrides.for_tenant(tenant)
        sz = size_bytes if size_bytes is not None else _approx_bytes(spans)
        self._admit(tenant, lim, sz, len(spans))

        self.metrics["spans_received_total"] += len(spans)
        self.metrics["bytes_received_total"] += sz
        self.usage.observe(tenant, spans, sz)
        self.dataquality.observe_spans(tenant, spans)

        orig_spans = spans
        if lim.ingestion.max_attribute_bytes:
            # truncation rewrites attrs; the raw payload no longer matches
            raw_otlp = None
            raw_recs = None

        spans, errs = self._validate(spans, lim)
        if not spans:
            return errs
        self.forwarders.offer(tenant, spans)  # async tee, never blocks

        groups, tid_matrix = _group_by_trace(spans)
        tokens = token_for(tenant, tid_matrix)
        if self.bus is not None:
            # ingest-storage path: partition-keyed records onto the bus
            # (`sendToKafka` distributor.go:612). REPLACES both the
            # ingester replication (the blockbuilder is the persister on
            # this path) and the direct generator tee (generators consume
            # the bus) — running either in parallel would persist or count
            # every span twice.
            from tempo_tpu_torch.ingest.encoding import produce_traces
            produce_traces(self.bus, tenant, groups, tokens)
            self.metrics["traces_pushed_total"] += len(groups)
            return errs
        errs2 = self._send_to_ingesters(tenant, groups, tokens, lim)
        for k, v in errs2.items():
            errs[k] = errs.get(k, 0) + v
        self._send_to_generators(tenant, groups, tokens, lim,
                                 raw_otlp=raw_otlp, raw_recs=raw_recs,
                                 orig_spans=orig_spans)
        return errs

    # -- stages ------------------------------------------------------------

    def _validate(self, spans: Sequence[dict],
                  lim) -> tuple[list[dict], dict[str, int]]:
        """Trace-id validation + attribute truncation
        (`pkg/validation` + distributor attr limits)."""
        errs: dict[str, int] = {}
        out: list[dict] = []
        max_attr = lim.ingestion.max_attribute_bytes
        for s in spans:
            tid = s.get("trace_id") or b""
            if not tid or len(tid) > 16:
                errs[REASON_INVALID_TRACE_ID] = errs.get(REASON_INVALID_TRACE_ID, 0) + 1
                self._discard(REASON_INVALID_TRACE_ID, 1)
                continue
            if max_attr:
                s = _truncate_attrs(s, max_attr)
            out.append(s)
        return out, errs

    def _send_to_ingesters(self, tenant: str,
                           groups: list[tuple[bytes, list[dict]]],
                           tokens: np.ndarray, lim) -> dict[str, int]:
        ring = self.ingester_ring
        if lim.ingestion.tenant_shard_size:
            ring = ring.shuffle_shard(tenant, lim.ingestion.tenant_shard_size)
        # per-trace reason, deduped across replicas: a trace rejected by all
        # RF replicas is one discarded trace, not RF of them
        item_reason: dict[int, str] = {}

        def send(inst: InstanceDesc, items: list[int]) -> None:
            client = self.ingester_clients[inst.id]
            res = client.push(tenant, [groups[i] for i in items])
            for i, reason in zip(items, res or ()):
                if reason:
                    item_reason.setdefault(i, reason)

        errs: dict[str, int] = {}
        try:
            do_batch(ring, tokens, list(range(len(groups))), send,
                     rf=self.cfg.rf)
            self.metrics["traces_pushed_total"] += len(groups)
        except RuntimeError:
            self.metrics["push_failures_total"] += 1
            n = sum(len(g[1]) for g in groups)
            self._discard(REASON_INTERNAL, n)
            errs[REASON_INTERNAL] = errs.get(REASON_INTERNAL, 0) + n
        for reason in item_reason.values():
            errs[reason] = errs.get(reason, 0) + 1
            self._discard(reason, 1)
        return errs

    def _send_to_generators(self, tenant: str,
                            groups: list[tuple[bytes, list[dict]]],
                            tokens: np.ndarray, lim,
                            raw_otlp: bytes | None = None,
                            raw_recs: "np.ndarray | None" = None,
                            orig_spans: Sequence[dict] | None = None) -> None:
        """Tee traces to metrics-generators (RF1, best-effort — generator
        loss degrades metrics, not trace durability; `distributor.go:563`).

        Always OTLP bytes on the wire (PushOTLP → the generator's
        vectorized staging): raw payload slices when the receiver handed
        one over, re-encoded from the span dicts otherwise. The per-span
        dict JSON tee is gone — it paid a triple decode (VERDICT r2 #10)."""
        if self.generator_ring is None or not self.generator_clients:
            return
        if not lim.generator.processors:
            return

        # original-order index per span object: maps validated dicts back
        # to raw wire slices without annotating them. Built only here —
        # the bus path and processor-less tenants never pay for it.
        recs = None
        n_scanned = -1
        wi_by_id: dict[int, int] = {}
        if raw_otlp is not None and orig_spans is not None:
            recs = raw_recs
            if recs is None:
                from tempo_tpu_torch import native
                try:
                    recs = native.otlp_scan(raw_otlp)
                except ValueError:
                    recs = None
            if recs is not None:
                n_scanned = len(recs)
                if n_scanned != len(orig_spans):
                    recs = None    # decode disagreement: re-encode instead
                else:
                    wi_by_id = {id(s): i for i, s in enumerate(orig_spans)}

        from tempo_tpu_torch.model.otlp import encode_spans_otlp, slice_otlp_payload

        def send(inst: InstanceDesc, items: list[int]) -> None:
            client = self.generator_clients[inst.id]
            if recs is not None:
                wis = [wi_by_id.get(id(s))
                       for i in items for s in groups[i][1]]
                if None not in wis:
                    if len(wis) == n_scanned:
                        client.push_otlp(tenant, raw_otlp)   # single target
                    else:
                        client.push_otlp(
                            tenant, slice_otlp_payload(raw_otlp, recs, wis))
                    return
            spans = [s for i in items for s in groups[i][1]]
            client.push_otlp(tenant, encode_spans_otlp(spans))

        self._send_generator_tee(tenant, tokens, len(groups), send)

    def _discard(self, reason: str, n: int) -> None:
        self.discarded[reason] = self.discarded.get(reason, 0) + n


# -- helpers ---------------------------------------------------------------

def _resource_service(raw: bytes, off: int, ln: int) -> str:
    """service.name of one Resource message region (columnar usage path)."""
    if off < 0 or ln <= 0:
        return ""
    from tempo_tpu_torch.model import proto_wire as pw
    from tempo_tpu_torch.model.otlp import _pb_attrs

    ra = _pb_attrs([v for f, _, v in pw.iter_fields(raw[off:off + ln])
                    if f == 1])
    v = ra.get("service.name")
    # dict-path parity: absent service attributes label as "" (the span
    # dict carries service="" there), not usage.MISSING
    return str(v) if v is not None else ""


def _group_by_trace(spans: Sequence[dict]
                    ) -> tuple[list[tuple[bytes, list[dict]]], np.ndarray]:
    """Regroup spans by trace id; returns groups + [n_groups,16] id matrix."""
    by_id: dict[bytes, list[dict]] = {}
    for s in spans:
        by_id.setdefault(s["trace_id"], []).append(s)
    groups = list(by_id.items())
    mat = np.zeros((len(groups), 16), np.uint8)
    for i, (tid, _) in enumerate(groups):
        b = tid.ljust(16, b"\0")[:16]
        mat[i] = np.frombuffer(b, np.uint8)
    return groups, mat


def _truncate_attrs(s: dict, max_bytes: int) -> dict:
    def trunc(attrs: dict | None) -> dict | None:
        if not attrs:
            return attrs
        out = {}
        for k, v in attrs.items():
            if len(k.encode()) > max_bytes:
                continue
            if isinstance(v, str) and len(v.encode()) > max_bytes:
                v = v.encode()[:max_bytes].decode(errors="ignore")
            out[k] = v
        return out

    s = dict(s)
    s["attrs"] = trunc(s.get("attrs"))
    s["res_attrs"] = trunc(s.get("res_attrs"))
    return s


def _approx_bytes(spans: Sequence[dict]) -> int:
    # shares the ingester's size heuristic so the distributor's rate limit
    # and the ingester's per-trace byte limit stay in the same units
    return _approx_size(list(spans))


__all__ = ["Distributor", "DistributorConfig", "RateLimited"]
