"""Invalid-block hooks: dump a debug witness when a payload fails.

A copy of the JAX package's ``engine/invalid_hooks.py`` on the port's modules.

Reference analogue: crates/engine/invalid-block-hooks/src/witness.rs —
on a bad block (state-root mismatch, post-execution failure) the tree
invokes installed hooks with everything needed for offline diagnosis.
The witness file carries the block RLP, the divergence, and the
execution output's state delta in hex — enough to replay the block
elsewhere and bisect executor-vs-trie disagreements.
"""

from __future__ import annotations

import json
from pathlib import Path


class InvalidBlockWitnessHook:
    """Writes one JSON witness per invalid block into ``directory``."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def __call__(self, block, reason: str, out=None,
                 computed_root: bytes | None = None) -> Path:
        witness = {
            "blockNumber": block.header.number,
            "blockHash": "0x" + block.hash.hex(),
            "reason": reason,
            "headerStateRoot": "0x" + block.header.state_root.hex(),
            "computedStateRoot": (
                "0x" + computed_root.hex() if computed_root else None
            ),
            "blockRlp": "0x" + block.encode().hex(),
        }
        if out is not None:
            witness["gasUsed"] = out.gas_used
            witness["postAccounts"] = {
                "0x" + a.hex(): (
                    None if acct is None else {
                        "nonce": acct.nonce,
                        "balance": str(acct.balance),
                        "codeHash": "0x" + acct.code_hash.hex(),
                    }
                )
                for a, acct in out.post_accounts.items()
            }
            witness["postStorage"] = {
                "0x" + a.hex(): {
                    "0x" + s.hex(): hex(v) for s, v in slots.items()
                }
                for a, slots in out.post_storage.items()
            }
        path = self.dir / f"{block.header.number}_{block.hash.hex()[:8]}.json"
        path.write_text(json.dumps(witness, indent=1))
        return path
