"""admin_ namespace: node info, peers, add/remove peer.

Reference analogue: the admin RPC impl (crates/rpc/rpc/src/admin.rs)
over the network handle — nodeInfo/peers mirror the devp2p identity and
live session set; addPeer dials an enode.

A copy of the JAX package's module. ``admin_addPeer`` re-raises a kernel
fault (``ops/_build.is_kernel_fault``) where the reference answers false
to any error.
"""

from __future__ import annotations

from ..ops._build import is_kernel_fault


class AdminApi:
    def __init__(self, network=None, discovery=None, chain_id: int = 1):
        self.network = network
        self.discovery = discovery
        self.chain_id = chain_id

    def admin_nodeInfo(self) -> dict:  # noqa: N802 — RPC method name
        if self.network is None:
            return {"enode": None, "ports": {}, "protocols": {}}
        from ..net.rlpx import node_id

        return {
            "enode": self.network.enode,
            "id": node_id(self.network.node_priv).hex(),
            "ip": self.network.host,
            "listenAddr": f"{self.network.host}:{self.network.port}",
            "ports": {
                "listener": self.network.port,
                "discovery": self.discovery.port if self.discovery else 0,
            },
            "protocols": {
                "eth": {"network": self.chain_id, "version": 68},
            },
        }

    def admin_peers(self) -> list:  # noqa: N802
        if self.network is None:
            return []
        out = []
        for peer in list(self.network.peers):
            hello = peer.session.remote_hello or {}
            out.append({
                "id": peer.node_id.hex(),
                "name": hello.get("client_id", ""),
                "caps": [f"{n}/{v}" for n, v in hello.get("caps", [])],
                "protocols": {"eth": {"version": 68}},
            })
        return out

    def admin_addPeer(self, enode_url: str) -> bool:  # noqa: N802
        if self.network is None:
            return False
        try:
            self.network.connect_to(enode_url)
            return True
        except Exception as e:  # noqa: BLE001 — dialing failures are not RPC errors
            if is_kernel_fault(e):
                raise
            return False

    def admin_removePeer(self, enode_url: str) -> bool:  # noqa: N802
        if self.network is None:
            return False
        from ..net.server import parse_enode
        from ..primitives.secp256k1 import pubkey_to_bytes

        try:
            pub, _h, _p = parse_enode(enode_url.partition("?")[0])
        except ValueError:
            return False
        nid = pubkey_to_bytes(pub)
        removed = False
        for peer in list(self.network.peers):
            if peer.node_id == nid:
                peer.session.disconnect()
                peer.close()
                try:  # outbound peers have no serve thread to clean up
                    self.network.peers.remove(peer)
                except ValueError:
                    pass
                removed = True
        return removed
