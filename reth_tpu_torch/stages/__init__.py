"""Staged sync: the pipeline and the state-commitment stages.

A copy of the JAX package's ``stages`` for the four commitment stages, in
the order the reference's ``default_stages`` runs them (``MerkleUnwindStage``
before the hashing stages, so that an unwind recomputes the trie after they
have reverted the hashed tables): ``MerkleUnwindStage``,
``AccountHashingStage``, ``StorageHashingStage``, ``MerkleStage``. The other
stages, and ``default_stages`` with them, are not ported yet (ROADMAP A
item 9).
"""

from .api import ExecInput, ExecOutput, Pipeline, Stage, StageError, UnwindInput
from .hashing import AccountHashingStage, StorageHashingStage
from .merkle import MerkleStage, MerkleUnwindStage


def default_stages(committer=None, consensus=None, evm_config=None) -> list[Stage]:
    """The reference's offline stage set: needs the execution, sender
    recovery and history stages, which are not ported yet."""
    raise NotImplementedError("default_stages needs the execution, sender recovery and "
                              "history stages (ROADMAP A item 9)")


__all__ = [
    "ExecInput",
    "ExecOutput",
    "Pipeline",
    "Stage",
    "StageError",
    "UnwindInput",
    "AccountHashingStage",
    "StorageHashingStage",
    "MerkleStage",
    "MerkleUnwindStage",
    "default_stages",
]
