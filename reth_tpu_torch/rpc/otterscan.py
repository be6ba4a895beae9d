"""Otterscan (ots_) namespace: block-explorer support API.

A copy of the JAX package's ``rpc/otterscan.py``.

Reference analogue: `OtterscanApi` (crates/rpc/rpc/src/otterscan.rs) —
the API level contract, block details with issuance/fee totals, paged
tx search per address, sender+nonce lookup, contract-creator lookup,
and trace-derived internal operations.
"""

from __future__ import annotations

from .convert import (
    block_to_rpc,
    data,
    header_to_rpc,
    parse_data,
    parse_qty,
    qty,
    receipt_to_rpc,
    tx_to_rpc,
)
from .server import RpcError

API_LEVEL = 8  # protocol level Otterscan 2.x expects


class OtterscanApi:
    def __init__(self, eth_api, debug_api):
        self.eth = eth_api
        self.debug = debug_api

    def _provider(self):
        return self.eth._provider()

    # -- protocol ----------------------------------------------------------

    def ots_getApiLevel(self):
        return API_LEVEL

    def ots_hasCode(self, address, tag="latest"):
        p = self.eth._state_at(tag)
        acc = p.account(parse_data(address))
        if acc is None:
            return False
        from ..primitives.keccak import keccak256

        return acc.code_hash != keccak256(b"")

    # -- blocks ------------------------------------------------------------

    def _block_details(self, p, n: int) -> dict:
        block = p.block_by_number(n)
        if block is None:
            raise RpcError(-32000, f"unknown block {n}")
        idx = p.block_body_indices(n)
        fees = 0
        if idx:
            base = block.header.base_fee_per_gas or 0
            prev_cum = 0
            for i, tx in enumerate(block.transactions):
                r = p.receipt(idx.first_tx_num + i)
                if r is None:
                    continue
                gas = r.cumulative_gas_used - prev_cum
                prev_cum = r.cumulative_gas_used
                fees += gas * tx.effective_gas_price(base)
        out = {
            "block": block_to_rpc(block, full_txs=False),
            "issuance": {"blockReward": qty(0), "uncleReward": qty(0),
                         "issuance": qty(0)},  # post-merge: no issuance
            "totalFees": qty(fees),
        }
        out["block"]["transactionCount"] = len(block.transactions)
        return out

    def ots_getBlockDetails(self, tag):
        p = self._provider()
        return self._block_details(p, self.eth._resolve_number(tag, p))

    def ots_getBlockDetailsByHash(self, block_hash):
        p = self._provider()
        n = p.block_number(parse_data(block_hash))
        if n is None:
            raise RpcError(-32000, "unknown block hash")
        return self._block_details(p, n)

    def ots_getBlockTransactions(self, tag, page, page_size):
        p = self._provider()
        n = self.eth._resolve_number(parse_qty(tag) if isinstance(tag, str)
                                     and tag.startswith("0x") else tag, p)
        block = p.block_by_number(n)
        if block is None:
            raise RpcError(-32000, f"unknown block {n}")
        page, page_size = int(page), int(page_size)
        idx = p.block_body_indices(n)
        start = page * page_size
        txs = block.transactions[start:start + page_size]
        full = []
        receipts = []
        for i, tx in enumerate(txs):
            gi = start + i
            full.append(tx_to_rpc(tx, block.header, gi))
            r = p.receipt(idx.first_tx_num + gi)
            if r is not None:
                prev_r = p.receipt(idx.first_tx_num + gi - 1) if gi else None
                prev = prev_r.cumulative_gas_used if prev_r else 0
                receipts.append(receipt_to_rpc(
                    r, tx, block.header, gi, prev,
                    p.sender(idx.first_tx_num + gi), 0))
        blk = block_to_rpc(block, full_txs=False)
        blk["transactionCount"] = len(block.transactions)
        return {"fullblock": {**blk, "transactions": full},
                "receipts": receipts}

    # -- address history (paged search) -------------------------------------

    def _candidate_blocks(self, p, address: bytes) -> list[int]:
        """Blocks where ``address``'s account changed, from the sharded
        AccountsHistory index (any tx the address sent or received moves
        its balance/nonce, so its history shards cover the search)."""
        from ..storage.tables import Tables

        cur = p.tx.cursor(Tables.AccountsHistory.name)
        blocks: list[int] = []
        entry = cur.seek(address)
        while entry is not None:
            key, value = entry
            if not key.startswith(address) or len(key) != len(address) + 8:
                break
            blocks.extend(
                int.from_bytes(value[i:i + 8], "big")
                for i in range(0, len(value), 8)
            )
            entry = cur.next()
        # blocks past the index checkpoint (the unpersisted live tip, a
        # persistence_threshold-bounded window) are searched directly
        indexed_to = p.stage_checkpoint("IndexAccountHistory")
        blocks.extend(range(indexed_to + 1, p.last_block_number() + 1))
        return blocks

    def _address_tx_numbers(self, p, address: bytes) -> list[int]:
        """All tx numbers touching ``address`` as sender or recipient,
        ascending — candidate blocks come from the history index, only
        those blocks' txs are inspected."""
        out = []
        for n in sorted(set(self._candidate_blocks(p, address))):
            idx = p.block_body_indices(n)
            if not idx:
                continue
            txs = p.transactions_by_block(n) or []
            for i, tx in enumerate(txs):
                sender = p.sender(idx.first_tx_num + i) or tx.recover_sender()
                if sender == address or tx.to == address:
                    out.append(idx.first_tx_num + i)
        return out

    def _search(self, address, block_num, page_size, before: bool):
        p = self._provider()
        addr = parse_data(address)
        block_num = parse_qty(block_num) if block_num else 0
        nums = self._address_tx_numbers(p, addr)
        if before and block_num:
            nums = [t for t in nums if (self.eth._block_of_tx(p, t) or 0) < block_num]
        elif not before and block_num:
            nums = [t for t in nums if (self.eth._block_of_tx(p, t) or 0) > block_num]
        if before:
            chosen = nums[-page_size:]
            first_page = len(nums) <= page_size
            last_page = True  # newest window
        else:
            chosen = nums[:page_size]
            first_page = True
            last_page = len(nums) <= page_size
        txs, receipts = [], []
        for t in chosen:
            bn = self.eth._block_of_tx(p, t)
            header = p.header_by_number(bn)
            bidx = p.block_body_indices(bn)
            i = t - bidx.first_tx_num
            tx = (p.transactions_by_block(bn) or [])[i]
            txs.append(tx_to_rpc(tx, header, i))
            r = p.receipt(t)
            if r is not None:
                prev_r = p.receipt(t - 1) if i else None
                prev = prev_r.cumulative_gas_used if prev_r else 0
                receipts.append(receipt_to_rpc(r, tx, header, i, prev,
                                               p.sender(t), 0))
        return {"txs": txs, "receipts": receipts,
                "firstPage": first_page, "lastPage": last_page}

    def ots_searchTransactionsBefore(self, address, block_num, page_size):
        return self._search(address, block_num, int(page_size), before=True)

    def ots_searchTransactionsAfter(self, address, block_num, page_size):
        return self._search(address, block_num, int(page_size), before=False)

    def ots_getTransactionBySenderAndNonce(self, address, nonce):
        p = self._provider()
        addr = parse_data(address)
        want = parse_qty(nonce)
        for t in self._address_tx_numbers(p, addr):
            bn = self.eth._block_of_tx(p, t)
            bidx = p.block_body_indices(bn)
            tx = (p.transactions_by_block(bn) or [])[t - bidx.first_tx_num]
            sender = p.sender(t) or tx.recover_sender()
            if sender == addr and tx.nonce == want:
                return data(tx.hash)
        return None

    def ots_getContractCreator(self, address):
        """(creator, creation tx) — found by replaying candidate txs'
        traces for a CREATE that produced ``address``."""
        p = self._provider()
        addr = parse_data(address)
        acc = p.account(addr)
        if acc is None:
            return None
        # the creation block is in the contract's own history shards
        for n in sorted(set(self._candidate_blocks(p, addr))):
            idx = p.block_body_indices(n)
            if not idx:
                continue
            txs = p.transactions_by_block(n) or []
            for i, tx in enumerate(txs):
                if tx.to is not None:
                    continue
                r = p.receipt(idx.first_tx_num + i)
                if r is None or not r.success:
                    continue
                sender = p.sender(idx.first_tx_num + i) or tx.recover_sender()
                from ..primitives.keccak import keccak256
                from ..primitives.rlp import encode_int, rlp_encode

                created = keccak256(rlp_encode([sender, encode_int(tx.nonce)]))[12:]
                if created == addr:
                    return {"creator": data(sender), "hash": data(tx.hash)}
        return None

    def ots_getTransactionError(self, tx_hash):
        """Revert output of a failed tx (empty for success)."""
        from .debug import StructLogger

        logger = StructLogger()
        result = self.debug._replay(tx_hash, logger)
        if result.success:
            return "0x"
        return data(result.output)

    def ots_traceTransaction(self, tx_hash):
        """Call-tree trace in Otterscan's flat format."""
        from .debug import CallTracer

        tracer = CallTracer()
        self.debug._replay(tx_hash, tracer)
        out = []

        def walk(node, depth):
            out.append({
                "type": node.get("type", "CALL"),
                "depth": depth,
                "from": node.get("from"),
                "to": node.get("to"),
                "value": node.get("value", "0x0"),
                "input": node.get("input", "0x"),
            })
            for c in node.get("calls", []):
                walk(c, depth + 1)

        walk(tracer.result(), 0)
        return out

    def ots_getInternalOperations(self, tx_hash):
        """Value transfers / creates / self-destructs inside a tx
        (types: 0 transfer, 1 selfdestruct, 2 create, 3 create2)."""
        from .debug import CallTracer

        tracer = CallTracer()
        self.debug._replay(tx_hash, tracer)
        ops = []

        def walk(node):
            kind = node.get("type", "CALL")
            value = int(node.get("value", "0x0"), 16)
            if kind in ("CALL", "CALLCODE") and value > 0:
                ops.append({"type": 0, "from": node["from"], "to": node["to"],
                            "value": node.get("value")})
            elif kind == "SELFDESTRUCT":
                ops.append({"type": 1, "from": node.get("from"),
                            "to": node.get("to"), "value": node.get("value", "0x0")})
            elif kind == "CREATE":
                ops.append({"type": 2, "from": node["from"], "to": node.get("to"),
                            "value": node.get("value", "0x0")})
            elif kind == "CREATE2":
                ops.append({"type": 3, "from": node["from"], "to": node.get("to"),
                            "value": node.get("value", "0x0")})
            for c in node.get("calls", []):
                walk(c)

        for c in tracer.result().get("calls", []):
            walk(c)
        return ops
