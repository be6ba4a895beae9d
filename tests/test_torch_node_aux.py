"""The node's helpers in the port against the JAX package's, tolerance zero:
the task runtime (tests/test_tasks_cache.py's task cases), the ExEx backfill
and its pruning gate (tests/test_exex_backfill.py) on both packages' nodes,
ethstats against a local dashboard (tests/test_ethstats.py), the event
streams and the events line (tests/test_aux2.py), the Chrome trace exporter,
the block wall budgets (tests/test_observability.py), the config loader and
the port's ``python -m reth_tpu_torch node`` as a process of its own."""

from __future__ import annotations

import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest
from _torch_node_pkgs import NPORT, NREF, ALICE, Account, ChainBuilder, Wallet, both, http, \
    ref_committer, request, result

ROOT = Path(__file__).resolve().parent.parent
BUILDER = ChainBuilder({Wallet(ALICE).address: Account(balance=10**21)},
                       committer=ref_committer())
BLOCK1 = ChainBuilder({Wallet(ALICE).address: Account(balance=10**21)},
                      committer=ref_committer())
BLOCK1.build_block([Wallet(ALICE).transfer(b"\x0b" * 20, 5)])


# -- the task runtime ---------------------------------------------------------


def test_graceful_shutdown_joins_tasks():
    def scenario(P):
        ex = P.tasks.TaskExecutor()
        ran = threading.Event()

        def loop(shutdown):
            ran.set()
            while not shutdown.wait(0.01):
                pass

        h = ex.spawn("loop", loop)
        obs = [ran.wait(5), h.alive, h.name, h.critical]
        return obs + [ex.graceful_shutdown(timeout=5), h.alive, h.thread.name]

    assert both(scenario) == [True, True, "loop", False, [], False, "reth-tpu/loop"]


def test_critical_and_noncritical_failures():
    def scenario(P):
        failures = []
        ex = P.tasks.TaskExecutor(on_critical_failure=lambda name, e, tb: failures.append(
            (name, repr(e), "kaboom" in tb)))

        def boom(shutdown):
            raise RuntimeError("kaboom")

        h = ex.spawn_critical("boom", boom)
        h.thread.join(5)
        quiet = ex.spawn("oops", lambda sd: (_ for _ in ()).throw(ValueError("x")))
        quiet.thread.join(5)
        return [repr(h.error), failures, [(n, repr(e)) for n, e in ex.critical_errors()],
                repr(quiet.error), ex.shutdown.is_set()]

    got = both(scenario)
    assert got[1] == [("boom", "RuntimeError('kaboom')", True)] and got[3] == "ValueError('x')"


# -- ExEx: backfill and the pruning gate --------------------------------------


def dev_node(P, d, **cfg_kw):
    cfg = P.NodeConfig(dev=True, datadir=str(d), genesis_header=P.header(BUILDER.genesis),
                       genesis_alloc=P.alloc(BUILDER.accounts_at_genesis),
                       persistence_threshold=cfg_kw.pop("persistence_threshold", 0), **cfg_kw)
    return P.node(cfg), Wallet(ALICE)


def test_backfill_reexecutes_history_with_outputs(tmp_path):
    """A late ExEx backfills blocks 1-6 in 2-block chunks: each arrives with
    the re-executed outputs, their receipts the stored ones."""
    def scenario(P):
        node, alice = dev_node(P, tmp_path / P.name)
        try:
            for i in range(6):
                node.pool.add_transaction(P.tx(alice.transfer(b"\x0b" * 20, 100 + i)))
                node.miner.mine_block()
            seen = []
            handle = node.exex.register("indexer", seen.append)
            delivered = node.exex.backfill(handle, node.factory, 1, 6, batch_blocks=2)
            receipts = []
            with node.factory.provider() as p:
                for n in seen:
                    for (num, _h), out in zip(n.blocks, n.outputs):
                        idx = p.block_body_indices(num)
                        receipts += [(r.cumulative_gas_used, r.success,
                                      p.receipt(idx.first_tx_num + i).cumulative_gas_used)
                                     for i, r in enumerate(out.receipts)]
            return [node.tree.persisted_number, delivered, [n.tip_number for n in seen],
                    [n.to_json() for n in seen], handle.finished_height, handle.backfilling,
                    receipts]
        finally:
            node.stop()

    got = both(scenario)
    assert got[:3] == [6, 3, [2, 4, 6]] and all(a == c for a, _, c in got[6])


def test_backfill_interleaves_with_live_notifications(tmp_path):
    """Live notifications reach every handle while one backfills; the
    backfiller's finished height stays at its own progress (the gate)."""
    def scenario(P):
        node, alice = dev_node(P, tmp_path / P.name, persistence_threshold=1)
        try:
            for i in range(4):
                node.pool.add_transaction(P.tx(alice.transfer(b"\x0c" * 20, 50 + i)))
                node.miner.mine_block()
            obs = [node.tree.persisted_number]
            live_seen, slow_seen = [], []
            node.exex.register("live", lambda n: live_seen.append(n.tip_number))
            slow = node.exex.register("slow", lambda n: slow_seen.append(n.tip_number))
            job = iter(P.exex.BackfillJob(node.factory, 1, 3, batch_blocks=2))
            slow.backfilling = True
            notification, outputs = next(job)
            slow.handler(notification)
            slow.finished_height = notification.tip_number
            obs += [node.exex.finished_height(), len(outputs)]
            node.pool.add_transaction(P.tx(alice.transfer(b"\x0c" * 20, 99)))
            node.miner.mine_block()
            return obs + [live_seen, slow_seen, slow.finished_height,
                          node.exex.finished_height()]
        finally:
            node.stop()

    assert both(scenario) == [3, 0, 2, [5], [2, 5], 2, 2]


def test_pruner_held_by_finished_height(tmp_path):
    """Receipts pruning waits for a backfilling ExEx; once its backfill
    completes the next canonical change prunes."""
    def scenario(P):
        modes = P.prune.PruneModes(receipts=P.prune.PruneMode(distance=1))
        node, alice = dev_node(P, tmp_path / P.name, prune_modes=modes)
        try:
            handle = node.exex.register("holder", lambda n: None)
            handle.backfilling = True
            for i in range(6):
                node.pool.add_transaction(P.tx(alice.transfer(b"\x0d" * 20, 10 + i)))
                node.miner.mine_block()
            with node.factory.provider() as p:
                held = p.receipt(p.block_body_indices(1).first_tx_num) is not None
            node.exex.backfill(handle, node.factory, 1, node.tree.persisted_number)
            gate = node.exex.finished_height()
            node.pool.add_transaction(P.tx(alice.transfer(b"\x0d" * 20, 999)))
            node.miner.mine_block()
            with node.factory.provider() as p:
                pruned = p.receipt(p.block_body_indices(1).first_tx_num) is None
            wal = (tmp_path / P.name / "exex_wal.jsonl").exists()
            return [held, gate, node.tree.persisted_number, pruned, wal]
        finally:
            node.stop()

    got = both(scenario)
    assert got[0] is True and got[3] is True


def test_exex_wal_replay_and_prune(tmp_path):
    """The ExEx WAL: notifications journaled before delivery, replayed above
    a height after a restart, pruned below one."""
    def scenario(P):
        d = tmp_path / P.name
        d.mkdir()
        m = P.exex.ExExManager(d)
        seen = []
        m.register("a", lambda n: seen.append(n.tip_number))
        for k in range(1, 5):
            m.notify(P.exex.CanonStateNotification(k, bytes([k]) * 32, [(k, bytes([k]) * 32)]))
        again = P.exex.ExExManager(d)
        replayed = []
        again.register("b", lambda n: replayed.append(n.tip_number))
        count = again.replay(from_height=2)
        again.prune_wal(3)
        return [seen, count, replayed, again._next_seq, (d / "exex_wal.jsonl").read_text()]

    assert both(scenario)[:3] == [[1, 2, 3, 4], 2, [3, 4]]


# -- ethstats -------------------------------------------------------------------


class FakeDashboard:
    """A minimal ethstats server on P's websocket helpers: records every emit
    and can ping the node."""

    def __init__(self, P):
        self.ws = P.ws
        self.listener = socket.create_server(("127.0.0.1", 0))
        self.port = self.listener.getsockname()[1]
        self.received = []
        self.conn = None
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self):
        try:
            sock, _ = self.listener.accept()
        except OSError:
            return
        self.ws.accept_handshake(sock)
        self.conn = sock
        while True:
            try:
                op, _fin, payload = self.ws.read_frame(sock)
            except Exception:  # noqa: BLE001 — the connection closed
                return
            if op == 0x1:
                self.received.append(json.loads(payload))

    def ping(self):
        self.ws.write_frame(self.conn, 0x1, json.dumps({"emit": ["node-ping", {}]}).encode())

    def topics(self):
        return [m["emit"][0] for m in self.received]

    def wait(self, topic: str, timeout: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and topic not in self.topics():
            time.sleep(0.02)
        return topic in self.topics()

    def close(self):
        self.listener.close()
        if self.conn:
            self.conn.close()


def test_parse_ethstats_url():
    def scenario(P):
        out = [P.ethstats.parse_ethstats_url("mynode:s3cret@stats.example.org:3000"),
               P.ethstats.parse_ethstats_url("n:@host")]
        with pytest.raises(ValueError) as err:
            P.ethstats.parse_ethstats_url("nohost")
        return out + [str(err.value)]

    assert both(scenario)[0] == ("mynode", "s3cret", "stats.example.org", 3000)


def test_ethstats_hello_stats_block_and_pong():
    """hello, then stats and pending; a mined block reported through the
    canon listener; node-ping answered with node-pong. The emits' shapes
    (their keys, the hello and the block) are the reference's."""
    def scenario(P):
        node = P.node(P.NodeConfig(dev=True, genesis_header=P.header(BUILDER.genesis),
                                   genesis_alloc=P.alloc(BUILDER.accounts_at_genesis)))
        dash = FakeDashboard(P)
        svc = P.ethstats.EthStatsService(f"test:sec@127.0.0.1:{dash.port}", node, interval=0.2)
        try:
            svc.start()
            waited = [dash.wait("stats"), dash.wait("pending")]
            node.pool.add_transaction(P.tx(Wallet(ALICE).transfer(b"\x0b" * 20, 5)))
            node.miner.mine_block()
            waited.append(dash.wait("block"))
            dash.ping()
            waited.append(dash.wait("node-pong"))
        finally:
            svc.stop()
            dash.close()
            node.stop()
        first = {}
        for m in dash.received:
            first.setdefault(m["emit"][0], m["emit"][1])
        block = [m["emit"][1] for m in dash.received if m["emit"][0] == "block"][-1]
        shapes = {t: sorted(v) if isinstance(v, dict) else type(v).__name__
                  for t, v in first.items()}
        hello = dict(first["hello"])
        return [waited, dash.topics()[0], hello, shapes, block]

    got = both(scenario)
    assert got[0] == [True] * 4 and got[1] == "hello"
    assert got[2]["id"] == "test" and got[2]["secret"] == "sec"


# -- event streams and the events line -------------------------------------------

# what each fragment of the events line reads: the metrics singletons' last
# records, the same on both packages while a line is made (the process's own
# records depend on which tests ran in it before)
CANNED = dict(
    pipeline_metrics={"windows": 3, "queue_peak": 2, "sweep_s": 0.5, "pack_s": 0.25,
                      "dispatch_s": 0.125, "fetch_s": 0.0625, "drained_windows": 1},
    fused_metrics={"k": 8, "dispatches": 2, "levels": 16, "mode": "perlevel"},
    sparse_commit_metrics={"tries": 3, "levels": 5, "dispatches": 4, "encode_chunks": 2,
                           "streamed": 1, "finish_s": 0.5},
    exec_metrics={"rounds": 2, "native": 3, "python": 1, "speculative": 4, "conflicts": 1,
                  "prefetched": 7, "workers": 4, "fallback": True, "wall_s": 0.5},
    tree_metrics={"invalid": 2, "invalid_cap": 512, "orphans": 1, "reorgs": 3, "max_depth": 2,
                  "storms": 1, "cancelled": 1, "backoff": True},
    block_pipeline_metrics={"depth": 2, "spec": 3, "adopted": 2, "aborted": 1, "overlap": 0.5,
                            "last_abort": "reorg", "lease_devices": 2},
    pool_metrics={"add": 5, "replace": 1, "drop": 2, "sheds": 1, "shipped": 3},
    producer_metrics={"refreshes": 2, "ranks": 5, "fresh": 3, "reexec": 2, "staleness_s": 1.0},
    hotstate_metrics={"hit_rate": 0.5, "arena": {"resident_rows": 10, "faults": 1},
                      "delta_fraction": 0.25, "cache": {"stale_drops": 1, "poison_caught": 1}})
BAL = {"waves": 2, "parallel": 3, "serial": 1, "native": 2}
BUDGET = dict({k: 1.5 for k in ("total_ms", "prewarm_ms", "exec_ms", "root_ms", "wait_ms",
                                "dispatch_ms", "encode_ms")}, number=7)


def canned_line(P, rep, summary=BUDGET) -> str:
    """``rep.report_once()`` with P's metrics singletons (and the last block
    budget) holding CANNED's records, restored after."""
    metrics = __import__(P.tracing.__name__.rsplit(".", 1)[0] + ".metrics",
                         fromlist=list(CANNED))
    saved = {n: getattr(metrics, n).last for n in CANNED}
    saved_bal, saved_budget = metrics.exec_metrics.last_bal, P.tracing._last_summary
    try:
        for n, rec in CANNED.items():
            getattr(metrics, n).last = dict(rec)
        metrics.exec_metrics.last_bal = dict(BAL)
        P.tracing._last_summary = summary
        return rep.report_once()
    finally:
        for n, rec in saved.items():
            getattr(metrics, n).last = rec
        metrics.exec_metrics.last_bal, P.tracing._last_summary = saved_bal, saved_budget


def test_event_stream_fanout_lag_and_close():
    def scenario(P):
        sender = P.events.EventSender(buffer=4)
        a, b = sender.new_listener(), sender.new_listener()
        for i in range(3):
            sender.notify(i)
        obs = [[a.next(0) for _ in range(3)]]
        for i in range(3, 10):
            sender.notify(i)
        obs += [[b.next(0) for _ in range(4)], b.dropped]
        done = []
        t = threading.Thread(target=lambda: done.extend(list(a)))
        t.start()
        sender.notify("last")
        time.sleep(0.05)
        sender.close()
        t.join(timeout=5)
        late = sender.new_listener()
        return obs + [t.is_alive(), done, late.next(0)]

    assert both(scenario) == [[0, 1, 2], [6, 7, 8, 9], 6, False, [6, 7, 8, 9, "last"], None]


def test_event_stream_unsubscribe():
    def scenario(P):
        sender = P.events.EventSender()
        s = sender.new_listener()
        s.unsubscribe()
        sender.notify("x")
        return [s.next(0)]

    assert both(scenario) == [None]


def test_node_event_reporter_line():
    """The events line over one canonical block, then a drained window; the
    event the listener received."""
    def scenario(P):
        block = P.types.Block.decode(BLOCK1.blocks[1].encode()) if P is NPORT \
            else BLOCK1.blocks[1]
        rep = P.node_events.NodeEventReporter(types.SimpleNamespace(pool=None, network=None),
                                              interval=999)
        stream = rep.sender.new_listener()
        rep.on_canon_change([types.SimpleNamespace(block=block)])
        line = canned_line(P, rep)
        ev = stream.next(0)
        return [line, rep.report_once(), (ev.number, ev.hash, ev.txs, ev.gas_used)]

    got = both(scenario)
    assert "number=1" in got[0] and "txs=1" in got[0] and got[1] is None
    for fragment in ("rebuild[", "fused[k=8", "sparse[", "exec[opt", "exec[bal", "tree[",
                     "pipe[", "pool[", "build[", "hot[", "| block 7 total=1.5ms"):
        assert fragment in got[0]


# -- tracing: the Chrome exporter and the block wall budgets ------------------------


def _traced_block(P, chrome: Path):
    """One traced block under P's default process role; the flight
    recorder's directory and the role are restored after (both packages
    keep them process-wide, and other tests set them)."""
    t = P.tracing
    saved = t._RECORDER.directory, t._ROLE
    t._ROLE = "node"
    t.init_block_tracing(chrome_path=chrome, flight_dir=chrome.parent)
    try:
        with t.trace_block("ab" * 32, number=7):
            with t.span("engine::prewarm", "prewarm"):
                pass
            with t.span("engine::execute", "execute", txs=3):
                pass
            with t.span("engine::tree", "state_root"):
                pass
            t.event("engine::tree", "canonical", number=7)
        summary = t.last_block_summary()
        recent = t.recent_block_summaries(1)
    finally:
        t.shutdown_block_tracing()
        t._RECORDER.directory, t._ROLE = saved
    return summary, recent


def test_chrome_trace_export_and_wall_budget(tmp_path):
    """One traced block on each package: the Chrome file is a valid JSON
    array with the same events (names, categories, phases, fields, parent
    links) and metadata; the block's wall budget has the reference's keys,
    and its one-line form (``format_wall_budget``) of a given budget is the
    reference's; the events line carries it."""
    def scenario(P):
        chrome = tmp_path / P.name / "blocks.trace.json"
        chrome.parent.mkdir()
        summary, recent = _traced_block(P, chrome)
        events = json.loads(chrome.read_text())
        ids = {e["args"].get("span_id"): i for i, e in enumerate(events)
               if e.get("ph") == "X"}
        shape = [(e["name"], e.get("cat"), e["ph"], e.get("s"),
                  sorted(k for k in e.get("args", {}) if k not in ("span_id", "parent_id")),
                  ids.get(e.get("args", {}).get("parent_id"))) for e in events]
        names = [e["args"]["name"].split("-")[0] for e in events if e["ph"] == "M"
                 and e["name"] == "process_name"]
        fixed = {k: 1.5 for k in ("total_ms", "prewarm_ms", "exec_ms", "root_ms", "wait_ms",
                                  "dispatch_ms", "encode_ms")}
        rep = P.node_events.NodeEventReporter(types.SimpleNamespace(pool=None, network=None),
                                              interval=999)
        block = P.types.Block.decode(BLOCK1.blocks[1].encode()) if P is NPORT \
            else BLOCK1.blocks[1]
        rep.on_canon_change([types.SimpleNamespace(block=block)])
        line = canned_line(P, rep, summary=summary)
        return [shape, names, sorted(summary), summary["number"], recent == [summary],
                P.tracing.format_wall_budget(dict(fixed, number=7)),
                line.split(" | ")[1].split(" total=")[0], P.tracing.read_chrome_trace(chrome)
                == events if hasattr(P.tracing, "read_chrome_trace") else True]

    got = both(scenario)
    assert got[3] == 7 and got[6] == "block 7"
    assert got[5] == ("block 7 total=1.5ms = prewarm 1.5 + exec 1.5 + root 1.5 "
                      "(wait 1.5, dispatch 1.5, encode 1.5)")


def test_config_loader(tmp_path):
    """``load_config`` of a reth.toml with every table, through the stdlib
    parser and the mini parser, and the defaults."""
    toml = tmp_path / "reth.toml"
    toml.write_text('[stages.merkle]\nrebuild_threshold = 7\n\n[node]\nhasher = "cpu"\n'
                    'mesh_devices = 4\nhot_state = true\nslo_interval = 0.5\n\n'
                    '[rpc]\ngateway = true\n\n[prune]\nreceipts = { distance = 100 }\n'
                    '# a comment\n')

    def scenario(P):
        cfg = __import__(P.cli.__name__.rsplit(".", 1)[0] + ".config",
                         fromlist=["load_config", "_mini_toml"])
        loaded, default = cfg.load_config(toml), cfg.load_config(None)
        return [repr(loaded), repr(default), cfg._mini_toml(toml.read_text())]

    got = both(scenario)
    assert "rebuild_threshold=7" in got[0]


# -- the port's node as a process -------------------------------------------------

_LOADED = ("import atexit, json, sys\n"
           "atexit.register(lambda: print('LOADED ' + json.dumps(sorted({{m.split('.')[0] "
           "for m in sys.modules}} & {{'jax', 'jaxlib', 'reth_tpu'}})), flush=True))\n"
           "import runpy\n"
           "sys.argv = [{pkg!r}] + {argv!r}\n"
           "runpy.run_module({pkg!r}, run_name='__main__')\n")


def _instant_sealing(pkg: str, argv: list[str], cwd: Path) -> dict:
    """``python -m <pkg> node --dev --block-time 0``: its RPC port from the
    printed line, a transfer from the dev key mined on arrival, SIGINT."""
    from reth_tpu.cli import DEV_PRIVATE_KEY
    from reth_tpu.rpc.convert import data

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    code = _LOADED.format(pkg=pkg, argv=["node", "--dev", "--block-time", "0", "--http-port",
                                         "0", "--authrpc-port", "0", "--disable-p2p"] + argv)
    proc = subprocess.Popen([sys.executable, "-u", "-c", code], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, port, out = [], None, ""
    try:
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"RPC listening on 127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port is not None, "".join(lines)
        tx = Wallet(DEV_PRIVATE_KEY).transfer(b"\x0b" * 20, 4321, chain_id=1337)
        sent = result(http(port, request("eth_sendRawTransaction", data(tx.encode())))[1])
        receipt = None
        while receipt is None and time.monotonic() < deadline:
            receipt = result(http(port, request("eth_getTransactionReceipt", sent))[1])
            time.sleep(0.05)
        balance = result(http(port, request("eth_getBalance", "0x" + "0b" * 20, "latest"))[1])
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines += out.splitlines(keepends=True)
    loaded = next(json.loads(x[len("LOADED "):]) for x in lines if x.startswith("LOADED "))
    return {"rc": proc.returncode, "receipt": {k: receipt[k] for k in (
        "status", "gasUsed", "blockNumber", "from", "to", "transactionHash")},
        "balance": balance, "mined": [x.split(" 0x")[0] for x in lines
                                      if x.startswith("mined block")],
        "loaded": loaded}


def test_dev_node_instant_sealing_as_a_process(tmp_path):
    """``python -m reth_tpu_torch node --dev --device cpu --block-time 0`` mines
    a sent transfer on arrival, exits 0 on SIGINT and has loaded no jax and
    nothing of ``reth_tpu``; the JAX package's node (``--hasher cpu``) gives
    the same receipt, balance and mining line."""
    port = _instant_sealing("reth_tpu_torch", ["--device", "cpu"], tmp_path)
    assert port["rc"] == 0 and port["loaded"] == []
    assert port["receipt"]["status"] == "0x1" and int(port["balance"], 16) == 4321
    assert port["mined"] == ["mined block 1 (1 txs)"]
    ref = _instant_sealing("reth_tpu", ["--hasher", "cpu"], tmp_path)
    assert ref["rc"] == 0
    assert {k: ref[k] for k in ("receipt", "balance", "mined")} == \
        {k: port[k] for k in ("receipt", "balance", "mined")}
