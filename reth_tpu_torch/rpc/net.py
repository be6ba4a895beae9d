"""net_* / web3_* / txpool_* / producer_* namespaces (reference
crates/rpc/rpc; producer_* is this repo's continuous-build operator
plane).

A copy of the JAX package's ``rpc/net.py``."""

from __future__ import annotations

from .convert import data, qty


class NetApi:
    def __init__(self, chain_id: int = 1, peer_count: int = 0):
        self.chain_id = chain_id
        self.peer_count = peer_count

    def net_version(self):
        return str(self.chain_id)

    def net_listening(self):
        return False

    def net_peerCount(self):
        return qty(self.peer_count)


class Web3Api:
    def web3_clientVersion(self):
        from .. import __version__

        return f"reth-tpu/v{__version__}"

    def web3_sha3(self, payload):
        from ..primitives.keccak import keccak256
        from .convert import parse_data

        return data(keccak256(parse_data(payload)))


class TxpoolApi:
    def __init__(self, pool):
        self.pool = pool

    def txpool_status(self):
        content = self.pool.content()
        return {
            "pending": qty(sum(len(v) for v in content["pending"].values())),
            "queued": qty(sum(len(v) for v in content["queued"].values())),
        }

    def txpool_content(self):
        from .convert import tx_to_rpc

        content = self.pool.content()
        return {
            bucket: {
                data(sender): {str(n): tx_to_rpc(tx) for n, tx in txs.items()}
                for sender, txs in senders.items()
            }
            for bucket, senders in content.items()
        }

    def txpool_contentFrom(self, address):
        """One sender's pending/queued txs, keyed by nonce directly (the
        geth/alloy TxpoolContentFrom shape — no address layer; reference
        txpool_contentFrom, crates/rpc/rpc/src/txpool.rs)."""
        from .convert import parse_data, tx_to_rpc

        target = parse_data(address)
        content = self.pool.content()
        return {
            bucket: {str(n): tx_to_rpc(tx)
                     for n, tx in senders.get(target, {}).items()}
            for bucket, senders in content.items()
        }

    def txpool_inspect(self):
        """Human-readable pool summary, geth's inspect string format
        (reference txpool_inspect, crates/rpc/rpc/src/txpool.rs)."""
        def line(tx):
            to = data(tx.to) if tx.to else "contract creation"
            price = tx.max_fee_per_gas if tx.tx_type >= 2 else tx.gas_price
            # the documented geth format uses the Unicode multiplication
            # sign, and parsers regex on it
            return (f"{to}: {tx.value} wei + {tx.gas_limit} gas "
                    f"\u00d7 {price} wei")

        content = self.pool.content()
        return {
            bucket: {
                data(sender): {str(n): line(tx) for n, tx in txs.items()}
                for sender, txs in senders.items()
            }
            for bucket, senders in content.items()
        }


class ProducerApi:
    """Operator introspection for the continuous block producer
    (payload/producer.py) — admitted in the engine class, mirroring
    fleet_* control-plane methods."""

    def __init__(self, producer):
        self.producer = producer

    def producer_status(self):
        return self.producer.snapshot()
