"""External-address resolution for the P2P listener (NAT handling).

Reference analogue: crates/net/nat — resolves the address advertised in
ENRs/enodes: an explicit `--nat extip:<ip>`, the listening interface, or
best-effort discovery. UPnP/PMP and external STUN-style services need
egress this environment forbids, so those strategies degrade to the
interface address with a recorded reason (the reference's `NatResolver`
falls back the same way when probing fails).
"""

from __future__ import annotations

import ipaddress
import socket
from dataclasses import dataclass


@dataclass(frozen=True)
class NatResolver:
    """Parsed `--nat` setting; ``external_ip`` resolves the advertised IP."""

    strategy: str = "any"        # any | none | extip
    explicit: str | None = None  # for extip:<ip>
    fallback_reason: str | None = None

    @classmethod
    def parse(cls, value: str) -> "NatResolver":
        v = value.strip().lower()
        if v in ("any", "none", "upnp", "natpmp"):
            reason = (f"{v} probing needs egress; using interface address"
                      if v in ("upnp", "natpmp") else None)
            return cls(strategy="any" if v != "none" else "none",
                       fallback_reason=reason)
        if v.startswith("extip:"):
            ip = value.split(":", 1)[1]
            ipaddress.ip_address(ip)  # validate; raises ValueError
            return cls(strategy="extip", explicit=ip)
        raise ValueError(f"unknown NAT strategy {value!r}")

    def external_ip(self, bind_host: str = "0.0.0.0") -> str:
        if self.strategy == "extip":
            return self.explicit  # type: ignore[return-value]
        if self.strategy == "none":
            return bind_host if bind_host not in ("0.0.0.0", "::") else "127.0.0.1"
        # "any": the interface a default route would use (no packets sent —
        # connect() on UDP just selects a source address)
        if bind_host not in ("0.0.0.0", "::", ""):
            return bind_host
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("10.254.254.254", 1))
            return s.getsockname()[0]
        except OSError:
            return "127.0.0.1"
        finally:
            s.close()
