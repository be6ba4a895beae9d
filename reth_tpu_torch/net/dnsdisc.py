"""DNS node discovery: signed ENR trees in TXT records (EIP-1459).

Reference analogue: crates/net/dns — `DnsDiscoveryService` walking
`enrtree://` links, resolving branch/leaf TXT records, verifying the
root signature against the tree key (src/tree.rs, src/sync.rs).

Tree grammar (each entry one TXT record):

  root:    enrtree-root:v1 e=<enr-root> l=<link-root> seq=<seq> sig=<b64>
  branch:  enrtree-branch:<h1>,<h2>,...
  leaf:    enr:<base64-record>   |   enrtree://<b32-pubkey>@<domain>

A subdomain's name is base32(keccak256(record-text)[:16], no padding).
The root signature is a 65-byte recoverable secp256k1 signature over
keccak256 of the root text up to (excluding) " sig=". DNS itself is
pluggable: any `resolve_txt(fqdn) -> str | None` callable — tests use a
dict, production can use a real resolver without new dependencies.
"""

from __future__ import annotations

import base64

from ..primitives import secp256k1
from ..primitives.keccak import keccak256
from ..primitives.secp256k1 import compress_pubkey, decompress_pubkey
from .enr import Enr

ROOT_PREFIX = "enrtree-root:v1"
BRANCH_PREFIX = "enrtree-branch:"
LINK_PREFIX = "enrtree://"
MAX_BRANCH_FANOUT = 13  # keeps branch TXT records under 370 bytes


class DnsDiscError(ValueError):
    pass


def _b32(data: bytes) -> str:
    return base64.b32encode(data).decode().rstrip("=").lower()


def _b32_key(pub: tuple[int, int]) -> str:
    return _b32(compress_pubkey(pub))


def _subdomain(record_text: str) -> str:
    return _b32(keccak256(record_text.encode())[:16])


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).decode().rstrip("=")


def _unb64(text: str) -> bytes:
    return base64.urlsafe_b64decode(text + "=" * (-len(text) % 4))


def link_url(pub: tuple[int, int], domain: str) -> str:
    return f"{LINK_PREFIX}{_b32_key(pub)}@{domain}"


def parse_link(url: str) -> tuple[tuple[int, int], str]:
    if not url.startswith(LINK_PREFIX):
        raise DnsDiscError("not an enrtree link")
    key_b32, _, domain = url[len(LINK_PREFIX):].partition("@")
    pad = "=" * (-len(key_b32) % 8)
    pub = decompress_pubkey(base64.b32decode(key_b32.upper() + pad))
    return pub, domain


class EnrTree:
    """Builder: ENRs + links -> the TXT record map for a domain."""

    def __init__(self, priv: int, seq: int = 1):
        self.priv = priv
        self.seq = seq

    def _hash_subtree(self, entries: list[str], records: dict[str, str]) -> str:
        """Insert entries, folding into branch records; returns root hash."""
        if not entries:
            return _subdomain("")  # conventional empty marker
        if len(entries) == 1:
            h = _subdomain(entries[0])
            records[h] = entries[0]
            return h
        hashes = []
        for e in entries:
            h = _subdomain(e)
            records[h] = e
            hashes.append(h)
        while len(hashes) > 1:
            nxt = []
            for i in range(0, len(hashes), MAX_BRANCH_FANOUT):
                branch = BRANCH_PREFIX + ",".join(hashes[i:i + MAX_BRANCH_FANOUT])
                bh = _subdomain(branch)
                records[bh] = branch
                nxt.append(bh)
            hashes = nxt
        return hashes[0]

    def build(self, domain: str, enrs: list[Enr],
              links: list[str] = ()) -> dict[str, str]:
        """-> {fqdn: txt} for the whole signed tree."""
        records: dict[str, str] = {}
        enr_root = self._hash_subtree([e.to_base64() for e in enrs], records)
        link_root = self._hash_subtree(list(links), records)
        unsigned = f"{ROOT_PREFIX} e={enr_root} l={link_root} seq={self.seq}"
        digest = keccak256(unsigned.encode())
        y, r, s = secp256k1.sign(digest, self.priv)
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([y])
        root = f"{unsigned} sig={_b64(sig)}"
        out = {domain: root}
        for sub, txt in records.items():
            out[f"{sub}.{domain}"] = txt
        return out


class DnsResolver:
    """Client: walk a domain's signed tree, yield verified ENRs.

    ``resolve_txt(fqdn) -> str | None`` abstracts DNS; pass a dict's
    ``.get`` in tests."""

    def __init__(self, resolve_txt, max_records: int = 1000):
        self.resolve_txt = resolve_txt
        self.max_records = max_records

    def _verify_root(self, root_txt: str, pub: tuple[int, int] | None) -> dict:
        if not root_txt.startswith(ROOT_PREFIX):
            raise DnsDiscError("missing enrtree-root")
        fields = dict(kv.split("=", 1) for kv in root_txt.split(" ")[1:])
        for k in ("e", "l", "seq", "sig"):
            if k not in fields:
                raise DnsDiscError(f"root missing {k}=")
        unsigned = root_txt[:root_txt.index(" sig=")]
        sig = _unb64(fields["sig"])
        if len(sig) != 65:
            raise DnsDiscError("bad root signature length")
        digest = keccak256(unsigned.encode())
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:64], "big")
        recovered = secp256k1.ecrecover(digest, sig[64], r, s,
                                        allow_high_s=True, return_pubkey=True)
        if pub is not None and recovered != (
                pub[0].to_bytes(32, "big") + pub[1].to_bytes(32, "big")):
            raise DnsDiscError("root signature does not match tree key")
        return fields

    def resolve_tree(self, link: str, _seen: set[str] | None = None) -> list[Enr]:
        """Resolve an enrtree:// link (verifying the root against its key),
        following link subtrees into other domains."""
        pub, domain = parse_link(link)
        seen = _seen if _seen is not None else set()
        if domain in seen:
            return []
        seen.add(domain)
        root_txt = self.resolve_txt(domain)
        if root_txt is None:
            return []
        fields = self._verify_root(root_txt, pub)
        out: list[Enr] = []
        out.extend(self._walk(domain, fields["e"], seen))
        for sub_link in self._walk_links(domain, fields["l"]):
            out.extend(self.resolve_tree(sub_link, seen))
        return out

    def _walk_entries(self, domain: str, h: str, seen: set[str]):
        stack = [h]
        count = 0
        while stack and count < self.max_records:
            sub = stack.pop()
            txt = self.resolve_txt(f"{sub}.{domain}")
            if txt is None:
                continue
            if _subdomain(txt) != sub:
                continue  # hash mismatch: poisoned record, skip
            count += 1
            if txt.startswith(BRANCH_PREFIX):
                stack.extend(x for x in txt[len(BRANCH_PREFIX):].split(",") if x)
            else:
                yield txt

    def _walk(self, domain: str, h: str, seen: set[str]) -> list[Enr]:
        out = []
        for txt in self._walk_entries(domain, h, seen):
            if txt.startswith("enr:"):
                try:
                    out.append(Enr.from_base64(txt))
                except Exception:  # noqa: BLE001 — bad record in tree
                    continue
        return out

    def _walk_links(self, domain: str, h: str) -> list[str]:
        return [txt for txt in self._walk_entries(domain, h, set())
                if txt.startswith(LINK_PREFIX)]
