"""The port's era archives (era.py, era_sync.py) against the JAX package's, on
the CPU.

The cases of tests/test_era.py and test_era_sync.py run on the port, its
pipelines on its card route on the CPU. Beyond them: the framed snappy and
e2store bytes are the reference's; ``export_era`` writes byte-identical era1
files in both packages and each package reads the other's; an era sync over
HTTP leaves the reference's tables; and a kernel fault in the era stage's
header check raises where any other error is a ``StageError``, as in the
reference.
"""

from __future__ import annotations

import http.server
import io
import os
import threading

import pytest

from _torch_net_pkgs import NPORT, NREF, SINK, fresh, synced, tables
from reth_tpu_torch.ops._build import LaunchError


@pytest.fixture(scope="module")
def chains():
    """Each package's node synced to block 6 of the same chain."""
    out = {P.name: synced(P, 6) for P in (NREF, NPORT)}
    assert out["port"][1].tip.hash == out["reference"][1].tip.hash
    return out


def test_crc32c_check_value():
    assert NPORT.era.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("payload", [b"", b"x", b"hello " * 1000, bytes(range(256)) * 300],
                         ids=["empty", "one", "text", "ramp"])
def test_snappy_framed_roundtrip_equal_bytes(payload):
    framed = NPORT.era.snappy_frame_compress(payload)
    assert framed == NREF.era.snappy_frame_compress(payload)
    assert NPORT.era.snappy_frame_decompress(framed) == payload


def test_snappy_framed_rejects_corruption():
    framed = bytearray(NPORT.era.snappy_frame_compress(b"data" * 100))
    framed[-1] ^= 0xFF
    with pytest.raises(NPORT.era.EraError):
        NPORT.era.snappy_frame_decompress(bytes(framed))


def test_e2store_records_roundtrip():
    bufs = []
    for P in (NPORT, NREF):
        buf = io.BytesIO()
        P.era.write_record(buf, 0x03, b"abc")
        P.era.write_record(buf, 0x3265, b"")
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1]
    assert list(NPORT.era.read_records(bufs[0])) == [(0x03, b"abc"), (0x3265, b"")]


def test_era1_files_equal_and_read_across(chains, tmp_path):
    """export_era writes the reference's bytes; each package reads the
    other's file to the same blocks, receipts and difficulties."""
    paths = {}
    for P in (NPORT, NREF):
        paths[P.name] = tmp_path / f"{P.name}-0.era1"
        assert P.era.export_era(chains[P.name][0], 1, 4, paths[P.name]) == 4
    assert paths["port"].read_bytes() == paths["reference"].read_bytes()
    b = chains["port"][1]
    for reader, path in ((NPORT, paths["reference"]), (NREF, paths["port"])):
        group = reader.era.read_era1(path)
        assert group.start_block == 1
        assert [blk.hash for blk in group.blocks] == [blk.hash for blk in b.blocks[1:5]]
        assert all(len(r) == 1 for r in group.receipts) and group.total_difficulties == [0] * 4
    ref_group, port_group = NREF.era.read_era1(paths["port"]), NPORT.era.read_era1(
        paths["port"])
    assert [list(map(bytes, r)) for r in port_group.receipts] == \
        [list(map(bytes, r)) for r in ref_group.receipts]


def test_era1_import_syncs_fresh_node(chains, tmp_path):
    factory, b = chains["port"]
    path = tmp_path / "chain-0.era1"
    NPORT.era.export_era(factory, 1, 6, path)
    node = fresh(NPORT, b)
    assert NPORT.era.import_era(node, path, NPORT.consensus()) == 6
    NPORT.Pipeline(node, NPORT.stages()).run(6)
    with node.provider() as p:
        assert p.header_by_number(6).state_root == b.tip.state_root
    assert tables(node) == tables(factory)


def test_era1_write_rejects_oversize(tmp_path):
    with pytest.raises(NPORT.era.EraError, match="at most"):
        NPORT.era.write_era1(tmp_path / "x.era1",
                             NPORT.era.Era1Group(0, [None] * 8193, [None] * 8193, [0] * 8193))


# -- the era stage and its downloader --------------------------------------------


@pytest.fixture()
def archive(chains, tmp_path):
    """Blocks 1-6 as two era1 archives and a checksum index (the port's)."""
    factory, b = chains["port"]
    src = tmp_path / "source"
    src.mkdir()
    NPORT.era.export_era(factory, 1, 3, src / "chain-00000.era1")
    NPORT.era.export_era(factory, 4, 6, src / "chain-00001.era1")
    assert NPORT.era_sync.EraSource.build_index(src) == 2
    return b, src


def test_era_stage_full_sync(chains, archive, tmp_path):
    b, src = archive
    es = NPORT.era_sync
    node = fresh(NPORT, b)
    dl = es.EraDownloader(es.EraSource(src), tmp_path / "cache")
    NPORT.Pipeline(node, [es.EraStage(dl, NPORT.consensus())] + NPORT.stages()).run(6)
    with node.provider() as p:
        assert p.stage_checkpoint("Finish") == 6
        assert p.header_by_number(6).state_root == b.blocks[6].header.state_root
        assert p.account(SINK).balance == sum(100 + i for i in range(6))
    assert (tmp_path / "cache" / "chain-00000.era1").exists()
    skip = ("StageCheckpoints", "StageCheckpointProgresses")
    assert tables(node, skip) == tables(chains["reference"][0], skip)


def test_era_stage_commits_per_archive_resumes_and_hands_off(archive, tmp_path):
    b, src = archive
    es = NPORT.era_sync
    node = fresh(NPORT, b)
    dl = es.EraDownloader(es.EraSource(src), tmp_path / "cache")
    ExecInput = NPORT.api.ExecInput
    with node.provider_rw() as p:
        out = es.EraStage(dl, NPORT.consensus()).execute(p, ExecInput(target=6, checkpoint=0))
        assert (out.checkpoint, out.done) == (3, False)
    with node.provider_rw() as p:
        out = es.EraStage(dl, NPORT.consensus()).execute(p, ExecInput(target=6, checkpoint=3))
        assert (out.checkpoint, out.done) == (6, True) and p.header_by_number(6) is not None
    other = fresh(NPORT, b)
    stage = es.EraStage(dl, NPORT.consensus())
    with other.provider_rw() as p:
        out = stage.execute(p, ExecInput(target=100, checkpoint=0))
        assert (out.checkpoint, out.done) == (3, False)
        out = stage.execute(p, ExecInput(target=100, checkpoint=3))
        assert (out.checkpoint, out.done) == (6, True)


def test_corrupt_archive_rejected(archive, tmp_path):
    b, src = archive
    es = NPORT.era_sync
    target = src / "chain-00001.era1"
    raw = bytearray(target.read_bytes())
    raw[100] ^= 0xFF
    target.write_bytes(bytes(raw))
    dl = es.EraDownloader(es.EraSource(src), tmp_path / "cache")
    entries = dict(es.EraSource(src).entries())
    dl.fetch("chain-00000.era1", entries["chain-00000.era1"])
    with pytest.raises(NPORT.era.EraError, match="checksum mismatch"):
        dl.fetch("chain-00001.era1", entries["chain-00001.era1"])
    assert not (tmp_path / "cache" / "chain-00001.era1").exists()


class _Consensus:
    """A consensus whose header check fails with ``err``."""

    def __init__(self, err):
        self.err = err

    def validate_header_against_parent(self, header, parent):
        raise self.err


@pytest.mark.parametrize("err", [LaunchError("keccak256_absorb: CUDA error 700"),
                                 ValueError("bad header")], ids=["kernel", "other"])
def test_era_stage_header_check_fault(chains, archive, tmp_path, err):
    """The departure at the era stage's catch-all: a kernel fault raises as
    itself; any other error becomes the reference's ``StageError``."""
    b, src = archive
    outcomes = []
    for P in (NPORT, NREF):
        es = P.era_sync
        node = fresh(P, chains[P.name][1])
        stage = es.EraStage(es.EraDownloader(es.EraSource(src), tmp_path / P.name),
                            _Consensus(err))
        with node.provider_rw() as p:
            try:
                stage.execute(p, P.api.ExecInput(target=6, checkpoint=0))
                outcomes.append(None)
            except Exception as e:  # noqa: BLE001 — the outcome is the observation
                outcomes.append((type(e).__name__, str(e)))
    port, ref = outcomes
    if isinstance(err, LaunchError):
        assert port == ("LaunchError", "keccak256_absorb: CUDA error 700")
        assert ref == ("StageError", "invalid era header 1: keccak256_absorb: CUDA error 700")
    else:
        assert port == ref == ("StageError", "invalid era header 1: bad header")


# -- the era source over HTTP -----------------------------------------------------


def serve_dir(root):
    """Serve a directory over HTTP with Range support."""

    class H(http.server.SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=str(root), **kw)

        def log_message(self, *a):
            pass

        def do_GET(self):
            path = self.translate_path(self.path)
            if not os.path.isfile(path):
                self.send_error(404)
                return
            data = open(path, "rb").read()
            rng = self.headers.get("Range")
            if rng and rng.startswith("bytes="):
                start = int(rng.split("=")[1].split("-")[0])
                if start >= len(data):
                    self.send_error(416)
                    return
                body = data[start:]
                self.send_response(206)
                self.send_header("Content-Range", f"bytes {start}-{len(data) - 1}/{len(data)}")
            else:
                body = data
                self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def test_http_era_sync_roundtrip_resume_and_corruption(chains, archive, tmp_path):
    """The era stage over a real HTTP server: index, ranged streams, checksum;
    a half-fetched ``.part`` resumes by a Range request; a corrupt archive is
    caught by the checksum."""
    b, src = archive
    es = NPORT.era_sync
    srv, url = serve_dir(src)
    try:
        source = es.era_source_for(url)
        assert isinstance(source, es.HttpEraSource)
        node = fresh(NPORT, b)
        stage = es.EraStage(es.EraDownloader(source, tmp_path / "cache"), NPORT.consensus())
        NPORT.Pipeline(node, [stage] + NPORT.stages()).run(6)
        with node.provider() as p:
            assert p.header_by_number(6).state_root == b.tip.state_root
        name, checksum = source.entries()[1]
        full = (src / name).read_bytes()
        cache = tmp_path / "resume"
        cache.mkdir()
        (cache / name.replace(".era1", ".part")).write_bytes(full[:len(full) // 2])
        assert es.EraDownloader(source, cache).fetch(name, checksum).read_bytes() == full
        raw = bytearray(full)
        raw[len(raw) // 2] ^= 0xFF
        (src / name).write_bytes(bytes(raw))
        with pytest.raises(NPORT.era.EraError, match="checksum"):
            es.EraDownloader(source, tmp_path / "bad").fetch(name, checksum)
    finally:
        srv.shutdown()
