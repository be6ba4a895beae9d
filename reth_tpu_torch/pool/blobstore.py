"""Blob sidecar store: memory + disk backends.

A copy of the JAX package's ``pool/blobstore.py`` on the port's
``primitives/kzg.py``.

Reference analogue: crates/transaction-pool/src/blobstore/ (mod.rs,
mem.rs, disk.rs) — blob sidecars live OUTSIDE the pool's tx index (they
are large), keyed by tx hash, inserted on pool admission, pruned when
the tx leaves the pool, and served to engine_getBlobsV1/V2 and the
pooled-tx network responses.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

from ..primitives import kzg
from ..primitives.rlp import rlp_decode, rlp_encode


class BlobStoreError(ValueError):
    pass


@dataclass(frozen=True)
class BlobSidecar:
    """blobs + KZG commitments + proofs of one type-3 transaction."""

    blobs: tuple[bytes, ...]
    commitments: tuple[bytes, ...]
    proofs: tuple[bytes, ...]

    def versioned_hashes(self) -> tuple[bytes, ...]:
        return tuple(kzg.kzg_to_versioned_hash(c) for c in self.commitments)

    def validate(self, expected_hashes: tuple[bytes, ...]) -> None:
        """Full admission validation: shape, hash binding, KZG proofs."""
        if not (len(self.blobs) == len(self.commitments) == len(self.proofs)):
            raise BlobStoreError("sidecar length mismatch")
        if not self.blobs:
            raise BlobStoreError("empty sidecar")
        if self.versioned_hashes() != tuple(expected_hashes):
            raise BlobStoreError("versioned hashes do not match commitments")
        for blob, commitment, proof in zip(self.blobs, self.commitments, self.proofs):
            if not kzg.verify_blob_kzg_proof(blob, commitment, proof):
                raise BlobStoreError("KZG blob proof verification failed")

    def encode(self) -> bytes:
        return rlp_encode([list(self.blobs), list(self.commitments),
                           list(self.proofs)])

    @classmethod
    def decode(cls, data: bytes) -> "BlobSidecar":
        f = rlp_decode(data)
        return cls(tuple(f[0]), tuple(f[1]), tuple(f[2]))


class InMemoryBlobStore:
    """Reference blobstore/mem.rs analogue."""

    def __init__(self):
        self._store: dict[bytes, BlobSidecar] = {}

    def insert(self, tx_hash: bytes, sidecar: BlobSidecar) -> None:
        self._store[tx_hash] = sidecar

    def get(self, tx_hash: bytes) -> BlobSidecar | None:
        return self._store.get(tx_hash)

    def delete(self, tx_hash: bytes) -> None:
        self._store.pop(tx_hash, None)

    def __len__(self) -> int:
        return len(self._store)

    def by_versioned_hashes(self, hashes) -> list[tuple[bytes, bytes] | None]:
        """(blob, proof) per requested versioned hash, None when unknown —
        the engine_getBlobsV1 lookup shape."""
        index: dict[bytes, tuple[bytes, bytes]] = {}
        for sc in self._store.values():
            for vh, blob, proof in zip(sc.versioned_hashes(), sc.blobs, sc.proofs):
                index.setdefault(vh, (blob, proof))
        return [index.get(h) for h in hashes]


class DiskBlobStore(InMemoryBlobStore):
    """Reference blobstore/disk.rs analogue: one RLP file per tx hash with
    a small hot cache (the in-memory parent acts as the cache)."""

    def __init__(self, directory):
        super().__init__()
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _path(self, tx_hash: bytes) -> Path:
        return self.dir / (tx_hash.hex() + ".blob")

    def insert(self, tx_hash: bytes, sidecar: BlobSidecar) -> None:
        super().insert(tx_hash, sidecar)
        tmp = self._path(tx_hash).with_suffix(".tmp")
        tmp.write_bytes(sidecar.encode())
        tmp.replace(self._path(tx_hash))

    def get(self, tx_hash: bytes) -> BlobSidecar | None:
        sc = super().get(tx_hash)
        if sc is not None:
            return sc
        p = self._path(tx_hash)
        if not p.exists():
            return None
        sc = BlobSidecar.decode(p.read_bytes())
        super().insert(tx_hash, sc)  # warm the cache
        return sc

    def delete(self, tx_hash: bytes) -> None:
        super().delete(tx_hash)
        try:
            os.unlink(self._path(tx_hash))
        except FileNotFoundError:
            pass

    def by_versioned_hashes(self, hashes) -> list[tuple[bytes, bytes] | None]:
        # warm every persisted sidecar first: after a restart the cache is
        # empty and a hash lookup must still see the on-disk files
        for p in self.dir.glob("*.blob"):
            tx_hash = bytes.fromhex(p.stem)
            if super().get(tx_hash) is None:
                self.get(tx_hash)
        return super().by_versioned_hashes(hashes)
