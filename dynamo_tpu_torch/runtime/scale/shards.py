"""Store sharding by keyspace family: one logical store, N dynstore procs.

``DYN_STORE_SHARDS`` declares a static shard map::

    DYN_STORE_SHARDS="telemetry=127.0.0.1:5001;traces=127.0.0.1:5002"

Each entry routes a comma-separated list of keyspace **family** names or
**shard group** names (the ``shard`` column of ``docs/keyspace.md`` —
``telemetry`` expands to metrics/metrics-stage/metrics-store/fleet-soak/
regions) to one dynstore address. Families not named anywhere (and the
``other`` fallback) stay on the default store every component is already
pointed at — so an empty/unset ``DYN_STORE_SHARDS`` is byte-identical to
the unsharded world.

:class:`ShardedStoreClient` exposes the full :class:`~dynamo_tpu_torch.runtime.
store_client.StoreClient` surface and routes every key-bearing call
through :func:`~dynamo_tpu_torch.runtime.keyspace.classify_key` to the owning
shard:

- ``put``/``get``/``create``/``delete`` and the ``q_*`` queue ops go to
  exactly one shard;
- ``get_prefix``/``watch_prefix`` resolve the prefix to its possible
  families (:func:`~dynamo_tpu_torch.runtime.keyspace.families_for_prefix`)
  and fan out only when the scan genuinely spans shards, merging the
  results; a partially-failed fan-out returns what the live shards hold
  and counts ``dyn_store_shard_errors_total{shard}``;
- **leases** are session-wide: ``lease_grant`` grants on the default
  shard and mirrors the lease onto every other shard under the same id
  (the server's ``reuse`` grant — the same mechanism session replay
  uses), so one worker lease bounds its keys on every shard and each
  per-shard client keeps its own keepalive + reconnect + replay loop;
- a shard being DOWN degrades only its families: calls routed to it
  raise the same typed ``StoreError(code="conn_lost")`` the unsharded
  client raises, while every other family keeps serving. Losing the
  lease on ANY shard fires the composite ``on_lease_lost`` — liveness
  is all-or-nothing, a worker half-registered across shards must
  restart rather than zombie-serve.

Pub/sub subjects are an event plane, not keys: they stay on the default
shard.
"""

from __future__ import annotations

import asyncio
import logging
import os
from dataclasses import dataclass
from typing import Awaitable, Callable, Dict, List, Optional, Set, Tuple

from .. import keyspace
from ..store_client import ReconnectConfig, StoreClient, StoreError

log = logging.getLogger("dynamo_tpu_torch.scale.shards")

WatchCallback = Callable[[str, Optional[bytes], bool], Awaitable[None]]


@dataclass(frozen=True)
class ShardSpec:
    """One dynstore process of the sharded store."""

    name: str          # "s0" (default) / "s1" / ... — the metric label
    host: str
    port: int


def _expand_token(token: str) -> List[str]:
    """A DYN_STORE_SHARDS token is a family name or a shard group name
    (which expands to every family registered under that group)."""
    token = token.strip()
    if token in keyspace.KEYSPACE:
        return [token]
    group = [f.name for f in keyspace.KEYSPACE.values()
             if f.shard == token]
    if group:
        return group
    raise ValueError(
        f"DYN_STORE_SHARDS names unknown family/group {token!r} "
        f"(families: {sorted(keyspace.KEYSPACE)}; groups: "
        f"{sorted({f.shard for f in keyspace.KEYSPACE.values()})})")


def parse_shard_map(raw: str, default_host: str, default_port: int
                    ) -> Tuple[List[ShardSpec], Dict[str, int]]:
    """``(specs, family->shard index)`` from the env syntax. Shard 0 is
    always the default store; entries sharing an address share a shard.
    A family routed twice is a config error, not a silent last-wins."""
    specs: List[ShardSpec] = [ShardSpec("s0", default_host, default_port)]
    addr_idx: Dict[Tuple[str, int], int] = {
        (default_host, default_port): 0}
    fam_map: Dict[str, int] = {}
    for entry in raw.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        names, _, addr = entry.partition("=")
        if not addr or ":" not in addr:
            raise ValueError(f"DYN_STORE_SHARDS entry {entry!r}: expected "
                             f"'<family|group>[,...]=host:port'")
        host, _, port_s = addr.rpartition(":")
        try:
            port = int(port_s)
        except ValueError:
            raise ValueError(f"DYN_STORE_SHARDS entry {entry!r}: "
                             f"malformed port {port_s!r}") from None
        idx = addr_idx.get((host, port))
        if idx is None:
            idx = len(specs)
            addr_idx[(host, port)] = idx
            specs.append(ShardSpec(f"s{idx}", host, port))
        for token in names.split(","):
            for fam in _expand_token(token):
                prev = fam_map.setdefault(fam, idx)
                if prev != idx:
                    raise ValueError(
                        f"DYN_STORE_SHARDS routes family {fam!r} to two "
                        f"shards (s{prev} and s{idx})")
    return specs, fam_map


def make_store_client(host: str, port: int,
                      reconnect: Optional[ReconnectConfig] = None,
                      shards_env: Optional[str] = None):
    """THE store-client constructor: a plain :class:`StoreClient` when
    ``DYN_STORE_SHARDS`` is unset/empty (zero-config single-store path,
    byte-identical behavior), a :class:`ShardedStoreClient` otherwise.
    ``host:port`` is always the default shard."""
    raw = os.environ.get("DYN_STORE_SHARDS", "") \
        if shards_env is None else shards_env
    if not raw.strip():
        return StoreClient(host, port, reconnect)
    specs, fam_map = parse_shard_map(raw, host, port)
    return ShardedStoreClient(specs, fam_map, reconnect)


class ShardedStoreClient:
    """N per-shard :class:`StoreClient` sessions behind the one-client
    API. See the module docstring for the routing/lease/degradation
    contract. ``clients`` is injectable for tests."""

    def __init__(self, specs: List[ShardSpec], fam_map: Dict[str, int],
                 reconnect: Optional[ReconnectConfig] = None,
                 clients: Optional[List] = None):
        if not specs:
            raise ValueError("sharded store needs at least the default "
                             "shard")
        self.specs = list(specs)
        self.fam_map = dict(fam_map)
        self.shards = (list(clients) if clients is not None else
                       [StoreClient(s.host, s.port, reconnect)
                        for s in specs])
        # the default shard answers for un-routed families and the
        # event/queue planes callers address without keys
        self.host, self.port = specs[0].host, specs[0].port
        self.reconnect = self.shards[0].reconnect \
            if hasattr(self.shards[0], "reconnect") else reconnect
        # primary lease id -> {shard idx -> that shard's lease id}
        # (ids match everywhere when the server honors ``reuse``; the
        # map absorbs servers that cannot)
        self._mirrors: Dict[int, Dict[int, int]] = {}
        self._lost_fired: Set[int] = set()
        self.on_lease_lost: Optional[Callable[[int], None]] = None
        self.on_session_replayed: Optional[Callable[[], None]] = None
        for i, sh in enumerate(self.shards):
            if hasattr(sh, "on_lease_lost"):
                sh.on_lease_lost = (
                    lambda lid, idx=i: self._shard_lease_lost(idx, lid))
            if hasattr(sh, "on_session_replayed"):
                sh.on_session_replayed = self._shard_replayed

    # -- identity ------------------------------------------------------
    @property
    def sharded(self) -> bool:
        return True

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def shard_names(self) -> List[str]:
        return [s.name for s in self.specs]

    def describe(self) -> List[Dict]:
        """Operator-facing map: shard -> address + owned families."""
        owned: Dict[int, List[str]] = {}
        for fam, idx in sorted(self.fam_map.items()):
            owned.setdefault(idx, []).append(fam)
        return [{"shard": s.name, "addr": f"{s.host}:{s.port}",
                 "families": owned.get(i, ["<default>"] if i == 0 else [])}
                for i, s in enumerate(self.specs)]

    # -- routing -------------------------------------------------------
    def _idx_for_family(self, fam: str) -> int:
        return self.fam_map.get(fam, 0)

    def _idx_for_key(self, key: str) -> int:
        return self._idx_for_family(keyspace.classify_key(key))

    def _idxs_for_prefix(self, prefix: str) -> List[int]:
        idxs: List[int] = []
        for fam in keyspace.families_for_prefix(prefix):
            i = self._idx_for_family(fam)
            if i not in idxs:
                idxs.append(i)
        return idxs or [0]

    def _count_error(self, idx: int) -> None:
        from ...utils.prometheus import stage_metrics

        stage_metrics().store_shard_errors.inc(self.specs[idx].name)

    # -- lifecycle -----------------------------------------------------
    async def connect(self) -> "ShardedStoreClient":
        # all shards must answer at startup (a component half-connected
        # to its keyspace is worse than one that fails to boot — same
        # strictness as the single-store client); on partial failure the
        # survivors are closed so a caller's retry loop leaks nothing
        results = await asyncio.gather(
            *(sh.connect() for sh in self.shards),
            return_exceptions=True)
        errs = [r for r in results if isinstance(r, BaseException)]
        if errs:
            for sh, r in zip(self.shards, results):
                if not isinstance(r, BaseException):
                    try:
                        await sh.close()
                    except Exception:  # noqa: BLE001 - best-effort
                        log.debug("shard close failed during connect "
                                  "rollback", exc_info=True)
            raise errs[0]
        return self

    async def close(self) -> None:
        await asyncio.gather(*(sh.close() for sh in self.shards),
                             return_exceptions=True)

    async def wait_connected(self) -> None:
        for sh in self.shards:
            await sh.wait_connected()

    async def ping(self) -> bool:
        results = await asyncio.gather(*(sh.ping() for sh in self.shards),
                                       return_exceptions=True)
        return all(r is True for r in results)

    # -- leases --------------------------------------------------------
    def _shard_lease_lost(self, idx: int, shard_lid: int) -> None:
        primary = next((p for p, m in self._mirrors.items()
                        if m.get(idx) == shard_lid), shard_lid)
        if primary in self._lost_fired:
            return
        self._lost_fired.add(primary)
        log.warning("lease %x lost on shard %s; session liveness is gone",
                    primary, self.specs[idx].name)
        if self.on_lease_lost is not None:
            try:
                self.on_lease_lost(primary)
            except Exception:
                log.exception("on_lease_lost callback")

    def _shard_replayed(self) -> None:
        if self.on_session_replayed is not None:
            try:
                self.on_session_replayed()
            except Exception:
                log.exception("on_session_replayed callback")

    async def lease_grant(self, ttl: float = 5.0,
                          auto_keepalive: bool = True,
                          bind: bool = True) -> int:
        lid = await self.shards[0].lease_grant(
            ttl, auto_keepalive=auto_keepalive, bind=bind)
        mirrors = {0: lid}
        try:
            for i, sh in enumerate(self.shards[1:], 1):
                mirrors[i] = await sh.lease_grant(
                    ttl, auto_keepalive=auto_keepalive, reuse=lid,
                    bind=bind)
        except Exception:
            # half-granted liveness is worse than no lease: roll back
            for i, mid in mirrors.items():
                try:
                    await self.shards[i].lease_revoke(mid)
                except Exception:  # noqa: BLE001 - best-effort rollback
                    log.debug("lease rollback failed on %s",
                              self.specs[i].name)
            raise
        self._mirrors[lid] = mirrors
        return lid

    def _lease_on(self, idx: int, lease: Optional[int]) -> Optional[int]:
        if lease is None:
            return None
        return self._mirrors.get(lease, {}).get(idx, lease)

    async def lease_revoke(self, lease: int) -> None:
        mirrors = self._mirrors.pop(lease, {0: lease})
        err: Optional[Exception] = None
        for i, sh in enumerate(self.shards):
            mid = mirrors.get(i)
            if mid is None:
                continue
            try:
                await sh.lease_revoke(mid)
            except Exception as e:  # noqa: BLE001 - revoke every shard
                # first; a dead shard's mirror expires by TTL anyway
                log.debug("lease revoke failed on %s",
                          self.specs[i].name, exc_info=True)
                if i == 0:
                    err = e
        if err is not None:
            raise err

    # -- KV ------------------------------------------------------------
    async def put(self, key: str, value: bytes,
                  lease: Optional[int] = None) -> None:
        idx = self._idx_for_key(key)
        await self.shards[idx].put(key, value,
                                   lease=self._lease_on(idx, lease))

    async def create(self, key: str, value: bytes,
                     lease: Optional[int] = None,
                     or_validate: bool = False) -> bool:
        idx = self._idx_for_key(key)
        return await self.shards[idx].create(
            key, value, lease=self._lease_on(idx, lease),
            or_validate=or_validate)

    async def get(self, key: str) -> Optional[bytes]:
        return await self.shards[self._idx_for_key(key)].get(key)

    async def delete(self, key: str) -> bool:
        return await self.shards[self._idx_for_key(key)].delete(key)

    async def get_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        idxs = self._idxs_for_prefix(prefix)
        if len(idxs) == 1:
            return await self.shards[idxs[0]].get_prefix(prefix)
        results = await asyncio.gather(
            *(self.shards[i].get_prefix(prefix) for i in idxs),
            return_exceptions=True)
        out: List[Tuple[str, bytes]] = []
        failed: List[int] = []
        for i, r in zip(idxs, results):
            if isinstance(r, BaseException):
                failed.append(i)
                self._count_error(i)
            else:
                out.extend(r)
        if failed and len(failed) == len(idxs):
            raise StoreError(
                f"get_prefix({prefix!r}): every owning shard failed",
                code="conn_lost")
        if failed:
            log.warning("get_prefix(%r): shard(s) %s down; serving the "
                        "surviving shards' slice", prefix,
                        [self.specs[i].name for i in failed])
        return sorted(out)

    async def get_prefix_on(self, idx: int, prefix: str
                            ) -> List[Tuple[str, bytes]]:
        """Read ONE shard's slice of a prefix (dyntop's per-shard store
        telemetry: every shard publishes its own self-dump under the
        same ``metrics_stage/_store/`` key)."""
        return await self.shards[idx].get_prefix(prefix)

    async def watch_prefix(self, prefix: str, callback: WatchCallback
                           ) -> List[Tuple[str, bytes]]:
        idxs = self._idxs_for_prefix(prefix)
        if len(idxs) == 1:
            return await self.shards[idxs[0]].watch_prefix(prefix,
                                                           callback)
        snapshots = await asyncio.gather(
            *(self.shards[i].watch_prefix(prefix, callback)
              for i in idxs))
        return sorted(x for snap in snapshots for x in snap)

    # -- pub/sub (event plane: default shard) --------------------------
    async def subscribe(self, subject: str, callback) -> int:
        return await self.shards[0].subscribe(subject, callback)

    async def publish(self, subject: str, payload: bytes) -> int:
        return await self.shards[0].publish(subject, payload)

    # -- queues --------------------------------------------------------
    async def q_push(self, queue: str, payload: bytes) -> int:
        return await self.shards[self._idx_for_key(queue)].q_push(
            queue, payload)

    async def q_pull(self, queue: str) -> Tuple[int, bytes]:
        # unbounded-ok: delegates to the owning shard's q_pull, whose
        # parked wait already survives reconnects and rejects on close
        return await self.shards[self._idx_for_key(queue)].q_pull(queue)

    async def q_ack(self, queue: str, msg_id: int) -> None:
        await self.shards[self._idx_for_key(queue)].q_ack(queue, msg_id)

    async def q_len(self, queue: str) -> int:
        return await self.shards[self._idx_for_key(queue)].q_len(queue)
