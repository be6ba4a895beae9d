"""Staged sync: the pipeline and its stages.

A copy of the JAX package's ``stages`` (reference crates/stages: the
`Stage` trait, `Pipeline`, the stage implementations and the
`DefaultStages` ordering), with the online stages (``HeadersStage``,
``BodiesStage``, ``online_stages``). Execution and sender recovery
run on the host; the hashing stages, the Merkle stages and the consensus's
receipts roots run on ``device`` (the card unless ``device="cpu"``).
"""

import torch

from .api import ExecInput, ExecOutput, Pipeline, Stage, StageError, UnwindInput
from .execution import ExecutionStage
from .finish import FinishStage
from .headers_bodies import BodiesStage, HeadersStage, online_stages
from .hashing import AccountHashingStage, StorageHashingStage
from .index_history import IndexAccountHistoryStage, IndexStorageHistoryStage
from .merkle import MerkleStage, MerkleUnwindStage
from .sender_recovery import SenderRecoveryStage
from .tx_lookup import TransactionLookupStage


def default_stages(committer=None, consensus=None, evm_config=None,
                   device: str | torch.device = "cuda") -> list[Stage]:
    """Offline stage set (headers/bodies come from import; reference
    `OfflineStages`, stages/src/sets.rs:302; MerkleUnwind placement per
    id.rs:46-58 so unwind order is correct). ``evm_config`` carries the
    chainspec so historical blocks execute under their own fork rules.
    Every stage that builds a committer (no ``committer``, or no
    ``consensus`` for the execution stage's post-execution checks) builds
    it on ``device``."""
    return [
        SenderRecoveryStage(),
        ExecutionStage(config=evm_config, consensus=consensus, device=device),
        MerkleUnwindStage(committer=committer, device=device),
        AccountHashingStage(committer=committer, device=device),
        StorageHashingStage(committer=committer, device=device),
        MerkleStage(committer=committer, device=device),
        TransactionLookupStage(),
        IndexStorageHistoryStage(),
        IndexAccountHistoryStage(),
        FinishStage(),
    ]


__all__ = [
    "ExecInput",
    "ExecOutput",
    "Pipeline",
    "Stage",
    "StageError",
    "UnwindInput",
    "ExecutionStage",
    "SenderRecoveryStage",
    "AccountHashingStage",
    "StorageHashingStage",
    "MerkleStage",
    "MerkleUnwindStage",
    "TransactionLookupStage",
    "IndexAccountHistoryStage",
    "IndexStorageHistoryStage",
    "FinishStage",
    "HeadersStage",
    "BodiesStage",
    "default_stages",
    "online_stages",
]
