"""Era archive sync: checksummed era1 acquisition + the Era pipeline stage.

Reference analogue: crates/era-downloader (fetch era1 files from an index,
verify sha256 against the published checksum list, stream them to the
import) and the `EraStage` that runs FIRST in the pipeline so pre-merge
history comes from archives instead of devp2p (stage ordering
crates/stages/types/src/id.rs: Era → Headers → Bodies → …).

No egress exists in this environment, so the transport is a filesystem /
file:// source — the architecture is identical: an index names the files
and their checksums, acquisition verifies BEFORE anything is parsed, and
corrupt archives are rejected with the file name.

A copy of the JAX package's module. The era stage's header check re-raises
a kernel fault (``ops/_build.is_kernel_fault``) where the reference turns
any error into a ``StageError``.
"""

from __future__ import annotations

import hashlib
import shutil
from pathlib import Path

from .era import EraError, read_era1
from .ops._build import is_kernel_fault
from .stages.api import ExecInput, ExecOutput, Stage, StageError, UnwindInput
from .storage.tables import Tables, be64


class EraSource:
    """An era archive source: a directory holding era1 files plus an
    ``index.txt`` of ``<filename> <sha256>`` lines (the reference's
    checksums file)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)

    def entries(self) -> list[tuple[str, str]]:
        index = self.root / "index.txt"
        if not index.exists():
            raise EraError(f"era source has no index.txt: {self.root}")
        out = []
        for line in index.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, checksum = line.split()
            out.append((name, checksum))
        return out

    def open_path(self, name: str) -> Path:
        return self.root / name

    @staticmethod
    def build_index(root: str | Path) -> int:
        """Write index.txt for every *.era1 in ``root`` (publisher side)."""
        root = Path(root)
        lines = []
        for p in sorted(root.glob("*.era1")):
            lines.append(f"{p.name} {hashlib.sha256(p.read_bytes()).hexdigest()}")
        (root / "index.txt").write_text("\n".join(lines) + "\n")
        return len(lines)


class HttpEraSource:
    """An era archive provider over HTTP (reference
    crates/era-downloader/src/client.rs): ``index.txt`` lives at
    ``<base>/index.txt``; archives stream with RANGED requests so an
    interrupted download resumes from the existing ``.part`` bytes
    instead of restarting. Checksums still gate everything downstream —
    a lying server can only waste bandwidth, never corrupt the import."""

    def __init__(self, base_url: str, timeout: float = 30.0,
                 chunk_size: int = 1 << 20):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.chunk_size = chunk_size

    def entries(self) -> list[tuple[str, str]]:
        import urllib.request

        try:
            with urllib.request.urlopen(
                    f"{self.base_url}/index.txt", timeout=self.timeout) as r:
                text = r.read().decode()
        except OSError as e:
            raise EraError(f"era index fetch failed: {e}")
        out = []
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, checksum = line.split()
            out.append((name, checksum))
        return out

    def fetch_into(self, name: str, tmp: Path) -> None:
        """Stream ``name`` into ``tmp``, resuming from its current size
        via a Range request when the server honors it (206)."""
        import urllib.error
        import urllib.request

        offset = tmp.stat().st_size if tmp.exists() else 0
        req = urllib.request.Request(f"{self.base_url}/{name}")
        if offset:
            req.add_header("Range", f"bytes={offset}-")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                mode = "ab" if offset and r.status == 206 else "wb"
                with open(tmp, mode) as f:
                    while True:
                        chunk = r.read(self.chunk_size)
                        if not chunk:
                            break
                        f.write(chunk)
        except urllib.error.HTTPError as e:
            if e.code == 416 and offset:  # range past EOF: already complete
                return
            raise EraError(f"era file fetch failed: {name}: {e}")
        except OSError as e:
            raise EraError(f"era file fetch failed: {name}: {e}")


def era_source_for(location: str | Path):
    """Pick the source type from the location: http(s) URL or local dir."""
    if isinstance(location, str) and location.startswith(("http://", "https://")):
        return HttpEraSource(location)
    return EraSource(location)


class EraDownloader:
    """Verified acquisition into a local cache directory."""

    def __init__(self, source, dest: str | Path):
        self.source = source
        self.dest = Path(dest)
        self.dest.mkdir(parents=True, exist_ok=True)

    def fetch(self, name: str, checksum: str) -> Path:
        """The verified local path for one archive; re-fetches on checksum
        mismatch, raises EraError when the source itself is corrupt."""
        target = self.dest / name
        if target.exists() and self._ok(target, checksum):
            return target
        tmp = target.with_suffix(".part")
        if hasattr(self.source, "fetch_into"):  # remote: ranged + resumed
            self.source.fetch_into(name, tmp)
        else:
            src = self.source.open_path(name)
            if not src.exists():
                raise EraError(f"era file missing from source: {name}")
            shutil.copyfile(src, tmp)
        if not self._ok(tmp, checksum):
            tmp.unlink(missing_ok=True)
            raise EraError(f"checksum mismatch for {name}")
        tmp.replace(target)
        return target

    @staticmethod
    def _ok(path: Path, checksum: str) -> bool:
        return hashlib.sha256(path.read_bytes()).hexdigest() == checksum.lower()

    def fetch_all(self) -> list[Path]:
        return [self.fetch(n, c) for n, c in self.source.entries()]


class EraStage(Stage):
    """First pipeline stage: pre-target history from era1 archives.

    Each committed chunk is one archive (headers + bodies inserted,
    parent-linkage validated); blocks past the last archive are left to
    the online Headers/Bodies stages. Reference
    crates/stages/stages/src/stages/era.rs.
    """

    id = "Era"

    def __init__(self, downloader: EraDownloader | None,
                 consensus=None):
        self.downloader = downloader
        self.consensus = consensus

    def execute(self, provider, inp: ExecInput) -> ExecOutput:
        if self.downloader is None:
            return ExecOutput(checkpoint=inp.target, done=True)
        tip = inp.checkpoint
        entries = self.downloader.source.entries()
        for pos, (name, checksum) in enumerate(entries):
            path = self.downloader.fetch(name, checksum)
            group = read_era1(path)
            last = group.start_block + len(group.blocks) - 1
            if last <= tip or group.start_block > inp.target:
                continue
            parent = provider.header_by_number(tip)
            for block in group.blocks:
                n = block.header.number
                if n <= tip or n > inp.target:
                    continue
                if n != tip + 1:
                    raise StageError(
                        f"era archive {name} is not contiguous at {n}", block=n)
                if self.consensus is not None and parent is not None:
                    try:
                        self.consensus.validate_header_against_parent(
                            block.header, parent)
                    except Exception as e:  # ConsensusError
                        if is_kernel_fault(e):
                            raise
                        raise StageError(f"invalid era header {n}: {e}", block=n)
                provider.insert_header(block.header)
                provider.insert_block_body(block)
                parent = block.header
                tip = n
            if tip >= inp.target:
                break
            if pos + 1 < len(entries):
                # one archive per commit: restart resumes at the next file
                return ExecOutput(checkpoint=tip, done=False)
        # archives exhausted (or none relevant): this stage is done; the
        # online stages continue from here
        return ExecOutput(checkpoint=max(tip, inp.checkpoint), done=True)

    def unwind(self, provider, inp: UnwindInput) -> None:
        for n in range(inp.checkpoint, inp.unwind_to, -1):
            key = be64(n)
            h = provider.tx.get(Tables.CanonicalHeaders.name, key)
            if h is not None:
                provider.tx.delete(Tables.HeaderNumbers.name, h)
            provider.tx.delete(Tables.CanonicalHeaders.name, key)
            provider.tx.delete(Tables.Headers.name, key)
            provider.tx.delete(Tables.BlockBodyIndices.name, key)
