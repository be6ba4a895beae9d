"""Human log dashboard of node progress events.

A copy of the JAX package's ``node/events.py``; every fragment reads the
port's ``metrics.py`` singletons. The SLO fragment reads the node's
``health`` attribute only: the health engine and its process default come
with the health slice (``ROADMAP.md`` A), so until then the line carries no
SLO fragment, as the reference's does without ``--health``.

Reference analogue: crates/node/events/src/node.rs — the periodic
"Status" / "Block added" INFO lines operators actually read: canonical
tip, throughput since the last report, txpool depth, peer count, and
stage progress during sync. Events arrive over an `EventSender` broadcast
(events.py); a reporter thread coalesces them into one line per interval
instead of one per block.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

from ..events import EventSender
from ..tracing import tracer

log = tracer("node::events")


@dataclass
class CanonUpdate:
    number: int
    hash: bytes
    txs: int
    gas_used: int


class NodeEventReporter:
    """Coalescing progress reporter over the node's event stream."""

    def __init__(self, node, interval: float = 10.0):
        self.node = node
        self.interval = interval
        self.sender = EventSender()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # window accumulators
        self._lock = threading.Lock()
        self._blocks = 0
        self._txs = 0
        self._gas = 0
        self._tip: CanonUpdate | None = None

    # -- event intake ---------------------------------------------------------

    def on_canon_change(self, chain) -> None:
        """Installed as an engine canon listener."""
        if not chain:
            return
        tip = chain[-1].block
        up = CanonUpdate(tip.header.number, tip.header.hash,
                         len(tip.transactions), tip.header.gas_used)
        with self._lock:
            self._blocks += len(chain)
            self._txs += sum(len(eb.block.transactions) for eb in chain)
            self._gas += sum(eb.block.header.gas_used for eb in chain)
            self._tip = up
        self.sender.notify(up)

    # -- reporting ------------------------------------------------------------

    def _snapshot(self):
        with self._lock:
            out = (self._blocks, self._txs, self._gas, self._tip)
            self._blocks = self._txs = self._gas = 0
            self._tip = None
            return out

    def report_once(self) -> str | None:
        blocks, txs, gas, tip = self._snapshot()
        if tip is None:
            return None
        pool = getattr(self.node, "pool", None)
        net = getattr(self.node, "network", None)
        pool_n = len(pool) if pool is not None else 0
        peer_n = len(net.peers) if net is not None else 0
        mgas = gas / 1e6
        line = (f"Canonical chain advanced  number={tip.number} "
                f"hash=0x{tip.hash.hex()[:16]}… blocks={blocks} txs={txs} "
                f"mgas={mgas:.2f} pool={pool_n} peers={peer_n}")
        # --hasher auto: the supervisor's breaker state belongs on the one
        # line operators read — a degraded (CPU-routed) hasher is exactly
        # the "node is slow, why?" answer
        sup = getattr(self.node, "hasher_supervisor", None)
        if sup is not None:
            s = sup.snapshot()
            line += (f" hasher={'cpu' if s['breaker'] != 'closed' else 'device'}"
                     f" breaker={s['breaker']}")
            if s["trips"] or s["failovers"]:
                line += f" trips={s['trips']} failovers={s['failovers']}"
        # --warmup: the compile lifecycle's one-line health — menu
        # progress, whether restarts hit the persistent cache, and how
        # much serving is still degraded onto the CPU twin ("the node is
        # slow right after start, why?" answer)
        wu = getattr(self.node, "warmup", None)
        if wu is not None:
            w = wu.snapshot()
            line += (f" warmup[{w['state']} {w['warm']}/{w['total']}"
                     f" cache={w['cache']['mode']}")
            if w["cache_hits"]:
                line += f" hits={w['cache_hits']}"
            if w["failed"]:
                line += f" failed={w['failed']}"
            if w["cpu_routed"]:
                line += f" cpu_routed={w['cpu_routed']}"
            line += f" wall={w['compile_wall_s']}s]"
        # --hash-service: the shared service's one-line health — queue
        # pressure, whether small batches actually fuse (cf = coalesce
        # factor), and the failure-path counters an operator pages on
        svc = getattr(self.node, "hash_service", None)
        if svc is not None:
            s = svc.snapshot()
            line += (f" hashsvc[q={s['queued_total']}"
                     f" cf={s['coalesce_factor']}"
                     f" disp={s['dispatches']}]")
            if s["replays"] or s["rejects"] or s["lease_bypasses"]:
                line += (f" svc_replays={s['replays']}"
                         f" svc_rejects={s['rejects']}"
                         f" svc_bypass={s['lease_bypasses']}")
            if s["leased_by"]:
                line += f" svc_leased={s['leased_by']}"
        # --mesh: the device mesh's one-line health — live/total devices,
        # whether a rebuild currently holds a sub-mesh lease, and the
        # degradation counters (devices shed by per-device breakers,
        # shrunken-mesh replays) an operator pages on
        hm = getattr(self.node, "hash_mesh", None)
        if hm is not None:
            m = hm.snapshot()
            line += f" mesh[{m['healthy']}/{m['total']}"
            if m["leased"]:
                line += f" leased={m['leased']}"
            if m["unhealthy"]:
                line += f" shed={m['unhealthy']}"
            svc_m = (svc.snapshot().get("mesh") if svc is not None else None)
            if svc_m is not None:
                line += (f" sharded={svc_m['sharded_dispatches']}"
                         f" single={svc_m['single_dispatches']}")
                if svc_m["mesh_replays"]:
                    line += f" replays={svc_m['mesh_replays']}"
            line += "]"
        # --rpc-gateway: the serving gateway's one-line health — queue
        # pressure per admission domain, whether duplicate reads actually
        # share work (cf = coalesce factor), cache effectiveness, and the
        # shed counter an operator pages on
        gw = getattr(self.node, "gateway", None)
        if gw is not None:
            g = gw.snapshot()
            line += (f" gateway[req={g['requests']}"
                     f" q={g['waiting_total']}"
                     f" cf={g['coalesce_factor']}"
                     f" hit={g['cache_hit_rate']}]")
            if g["sheds"]:
                line += f" gw_sheds={g['sheds']}"
        # --fleet: the replica fleet's one-line health — ring membership
        # (healthy/registered), worst feed lag, how many reads actually
        # landed on replicas vs failed over or fell back to this node,
        # and the feed's fanout state (subscribers, witness bytes/block)
        # — the numbers that say the fleet is absorbing read traffic
        fr = getattr(self.node, "fleet_router", None)
        if fr is not None:
            f = fr.snapshot()
            line += (f" fleet[{f['healthy']}/{f['registered']}"
                     f" routed={f['routed']}")
            if f["max_lag"]:
                line += f" lag^={f['max_lag']}"
            if f["failovers"]:
                line += f" fo={f['failovers']}"
            if f["local_fallbacks"]:
                line += f" local={f['local_fallbacks']}"
            if f["sheds"]:
                line += f" sheds={f['sheds']}"
            fs = getattr(self.node, "feed_server", None)
            if fs is not None:
                s = fs.snapshot()
                line += (f" feed={s['subscribers']}sub"
                         f"/{s['blocks_sent']}blk")
                if s["last_witness_bytes"]:
                    line += f" wit={s['last_witness_bytes']}B"
                if s["witness_failures"]:
                    line += f" witfail={s['witness_failures']}"
            line += "]"
        # --fleet: the observability plane's one-line health — how many
        # replicas the metrics federation is actually pulling (stale =
        # the fleet view is partially blind), pull cadence/failures, and
        # correlated flight-dump fan-outs — the numbers that say the
        # fleet is OBSERVABLE, not just serving
        fed = getattr(self.node, "fleet_federation", None)
        if fed is not None:
            fo = fed.snapshot()
            line += (f" fleetobs[{fo['replicas'] - fo['stale']}"
                     f"/{fo['replicas']} pulls={fo['pulls']}")
            if fo["stale"]:
                line += f" stale={fo['stale']}"
            if fo["failures"]:
                line += f" fail={fo['failures']}"
            fs = getattr(self.node, "feed_server", None)
            if fs is not None and fs.flight_fanouts:
                line += f" dumps={fs.flight_fanouts}"
            line += "]"
        # HA: this leader's durable-stream shipping + fencing state —
        # epoch lineage, how many standbys ride the WAL stream, records
        # shipped vs dropped (a standby too slow for the ship queue),
        # and whether this node is fenced (superseded by a promotion)
        fs = getattr(self.node, "feed_server", None)
        if fs is not None:
            s = fs.snapshot()
            if s.get("wal_subscribers") or s.get("st_records_sent") \
                    or getattr(self.node.tree, "fenced", False):
                line += (f" ha[epoch={s['epoch']}"
                         f" standbys={s['wal_subscribers']}"
                         f" shipped={s['st_records_sent']}")
                if s.get("st_dropped"):
                    line += f" dropped={s['st_dropped']}"
                if s.get("resyncs_sent"):
                    line += f" resyncs={s['resyncs_sent']}"
                if s.get("partition_suppressed"):
                    line += f" part={s['partition_suppressed']}"
                if getattr(self.node.tree, "fenced", False):
                    line += " FENCED"
                line += "]"
        # rebuild-pipeline stage walls: during a chunked Merkle rebuild this
        # is the line that says where the time goes (host sweep vs hashing)
        from ..metrics import pipeline_metrics

        pm = pipeline_metrics.last
        if pm is not None:
            line += (f" rebuild[win={pm['windows']} q^={pm['queue_peak']}"
                     f" sweep={pm['sweep_s']}s pack={pm['pack_s']}s"
                     f" disp={pm['dispatch_s']}s fetch={pm['fetch_s']}s]")
            if pm["drained_windows"]:
                line += f" drained={pm['drained_windows']}"
        # whole-subtrie fused commits: the k-level engine's one-line
        # health — configured k, device dispatches the last commit
        # actually issued for how many staged levels, and which rung
        # produced the digests (fused / perlevel / cpu). A mode other
        # than "fused" — or disp creeping toward lv — is the dispatch-
        # count regression the fused SLO rule pages on.
        from ..metrics import fused_metrics

        fm = fused_metrics.last
        if fm is not None:
            line += (f" fused[k={fm['k']} disp={fm['dispatches']}"
                     f" lv={fm['levels']}")
            if fm["mode"] != "fused":
                line += f" {fm['mode'].upper()}"
            line += "]"
        # parallel sparse commit: the live-tip finish path's one-line
        # health — how many depth levels packed across tries, fused
        # dispatches per block, encode-chunk fan-out, and the finish wall
        from ..metrics import sparse_commit_metrics

        sc = sparse_commit_metrics.last
        if sc is not None:
            line += (f" sparse[tries={sc.get('tries', 0)}"
                     f" lv={sc.get('levels', 0)}"
                     f" disp={sc.get('dispatches', 0)}"
                     f" enc={sc.get('encode_chunks', 0)}")
            if sc.get("streamed"):
                line += f" strm={sc['streamed']}"
            if "finish_s" in sc:
                line += f" fin={sc['finish_s']}s"
            line += "]"
        # parallel execution: the last block's scheduling efficiency —
        # optimistic (engine/optimistic.py: native/python rank split,
        # speculative commits vs serial re-runs, rounds, prefetched keys)
        # or BAL wave stats (engine/bal.py) — so BAL-hinted vs optimistic
        # scheduling is comparable on the one line operators read
        from ..metrics import exec_metrics

        ex = exec_metrics.last
        if ex is not None:
            line += (f" exec[opt r={ex.get('rounds', 0)}"
                     f" nat={ex.get('native', 0)}"
                     f" py={ex.get('python', 0)}"
                     f" spec={ex.get('speculative', 0)}"
                     f" conf={ex.get('conflicts', 0)}"
                     f" pre={ex.get('prefetched', 0)}"
                     f" w={ex.get('workers', 0)}")
            if ex.get("fallback"):
                line += " FALLBACK"
            if "wall_s" in ex:
                line += f" {ex['wall_s']}s"
            line += "]"
        eb = exec_metrics.last_bal
        if eb is not None:
            line += (f" exec[bal waves={eb.get('waves', 0)}"
                     f" par={eb.get('parallel', 0)}"
                     f" ser={eb.get('serial', 0)}"
                     f" nat={eb.get('native', 0)}]")
        # consensus robustness: the engine tree's one-line adversarial
        # health — invalid-cache occupancy vs its bound (a flood must
        # plateau), orphan-buffer depth, reorg cadence/depth, storm
        # detections with their backoff, and inserts cancelled by a
        # reorging forkchoice — the numbers that say a hostile CL is
        # being absorbed instead of hurting the node
        from ..metrics import tree_metrics

        tm = tree_metrics.last
        if tm and (tm.get("invalid") or tm.get("orphans")
                   or tm.get("reorgs") or tm.get("cancelled")):
            line += (f" tree[inv={tm.get('invalid', 0)}"
                     f"/{tm.get('invalid_cap', 0)}"
                     f" orph={tm.get('orphans', 0)}"
                     f" reorgs={tm.get('reorgs', 0)}")
            if tm.get("max_depth"):
                line += f" depth^={tm['max_depth']}"
            if tm.get("storms"):
                line += f" storms={tm['storms']}"
            if tm.get("cancelled"):
                line += f" cancelled={tm['cancelled']}"
            if tm.get("backoff"):
                line += " BACKOFF"
            line += "]"
        # cross-block import pipeline: speculations started/adopted/
        # aborted, the measured exec-inside-commit overlap fraction, and
        # the last abort-ladder rung — the one-line answer to "is
        # back-to-back import actually overlapping exec with commit"
        from ..metrics import block_pipeline_metrics

        bp = block_pipeline_metrics.last
        if bp and bp.get("spec"):
            line += (f" pipe[d={bp.get('depth', 2)}"
                     f" spec={bp.get('spec', 0)}"
                     f" adopt={bp.get('adopted', 0)}"
                     f" abort={bp.get('aborted', 0)}")
            if "overlap" in bp:
                line += f" ovl={bp['overlap']:.2f}"
            if bp.get("last_abort"):
                line += f" last={bp['last_abort']}"
            if bp.get("lease_devices"):
                line += f" lease={bp['lease_devices']}d"
            line += "]"
        # write-path firehose: pool admissions/replacements/drops since
        # start, -32005 sheds, and pt_* records shipped to the fleet —
        # the one-line answer to "is the firehose being absorbed"
        from ..metrics import pool_metrics, producer_metrics

        pl = pool_metrics.last
        if pl:
            line += (f" pool[add={pl.get('add', 0)}"
                     f" repl={pl.get('replace', 0)}"
                     f" drop={pl.get('drop', 0)}")
            if pl.get("sheds"):
                line += f" shed={pl['sheds']}"
            if pl.get("shipped"):
                line += f" ship={pl['shipped']}"
            line += "]"
        # continuous producer: candidate size, incremental economy
        # (fresh-executed vs replayed ranks), refresh cadence, staleness
        pr = producer_metrics.last
        if pr and pr.get("refreshes"):
            line += (f" build[ranks={pr.get('ranks', 0)}"
                     f" fresh={pr.get('fresh', 0)}"
                     f" re={pr.get('reexec', 0)}"
                     f" refr={pr.get('refreshes', 0)}")
            if pr.get("staleness_s", 0) > 0.5:
                line += f" stale={pr['staleness_s']:.1f}s"
            line += "]"
        # hot-state plane (--hot-state): node-cache hit rate, resident
        # arena rows, last delta-upload fraction, and the validation
        # catches (stale/poison) — the one-line answer to "is the
        # cross-block cache actually absorbing proof fetches"
        from ..metrics import hotstate_metrics

        hs = hotstate_metrics.last
        if hs:
            line += f" hot[hit={hs.get('hit_rate', 0.0):.2f}"
            ar = hs.get("arena")
            if ar:
                line += f" rows={ar.get('resident_rows', 0)}"
            if "delta_fraction" in hs:
                line += f" dfrac={hs['delta_fraction']:.2f}"
            c = hs.get("cache") or {}
            caught = c.get("stale_drops", 0) + c.get("poison_caught", 0)
            if caught:
                line += f" caught={caught}"
            if ar and ar.get("faults"):
                line += f" faults={ar['faults']}"
            line += "]"
        # --health: the SLO engine's verdict — node status, any non-ok
        # component, and the breach counter an operator pages on. The
        # one line that says "the node itself thinks it is sick" instead
        # of leaving the judgment to whoever reads the fragments above.
        eng = getattr(self.node, "health", None)
        if eng is not None:
            comps = eng.components()
            bad = [f"{c}:{s}" for c, s in sorted(comps.items())
                   if s != "ok"]
            line += f" slo[{eng.status()}"
            if bad:
                line += " " + ",".join(bad)
            if eng.breaches_total:
                line += f" breaches={eng.breaches_total}"
            line += "]"
        # --wal: the durability boundary's one-line health — generation,
        # fsync'd appends since start, checkpoints taken, live segment
        # size — the numbers that say what a kill -9 right now would
        # cost; plus the last startup recovery's verdict (replayed
        # records, torn tail discarded, quarantines, root proof)
        dur = getattr(self.node, "durability", None)
        if dur is not None:
            d = dur.snapshot()
            line += (f" wal[gen={d['gen']} app={d['appends']}"
                     f" ckpt={d['checkpoints']}"
                     f" seg={d['segment_bytes']}B]")
        rec = getattr(self.node, "recovery", None)
        if rec is not None and (rec.get("replayed_records")
                                or rec.get("status") != "ok"
                                or rec.get("healed")):
            line += (f" recovery[{rec['status']}"
                     f" replayed={rec.get('replayed_records', 0)}")
            if rec.get("torn_bytes"):
                line += f" torn={rec['torn_bytes']}B"
            if rec.get("quarantined"):
                line += f" quarantined={len(rec['quarantined'])}"
            if rec.get("root_verified") is not None:
                line += (" root=ok" if rec["root_verified"]
                         else " root=MISMATCH")
            line += "]"
        # --trace-blocks: the per-block wall budget — where the last
        # block's time actually went, split by phase and by hash-service
        # queue-wait vs device dispatch (tracing.py block summaries)
        from .. import tracing

        budget = tracing.last_block_summary()
        if budget is not None:
            line += " | " + tracing.format_wall_budget(budget)
        log.info(line)
        return line

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.report_once()
            except Exception:  # noqa: BLE001 — reporting must never kill the node
                pass

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="node-events")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self.sender.close()
        if self._thread is not None:
            self._thread.join(timeout=2)
