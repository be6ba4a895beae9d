"""Engine (live tip): in-memory block tree, payload validation, forkchoice.

A copy of the JAX package's ``engine``: the tree (``tree.py EngineTree``:
``on_new_payload`` / ``on_forkchoice_updated``, orphan buffering, invalid
ancestors, reorgs, deep-reorg unwinds and persistence), its state-root
strategies (``sparse_root.py SparseRootTask`` on the card, or
``pipelined_root.py PipelinedStateRoot`` with the incremental committer),
the execution cache and prewarm, the parallel executors (``bal.py``,
``optimistic.py`` and the native core ``native_exec.py``), the cross-block
import pipeline (``block_pipeline.py``), and the middleware (``util.py``,
``invalid_hooks.py``). Each pending block's entire effect is one overlay
layer (``storage/overlay.py``); persistence applies layers in canonical
order.

Block production and stateless validation: the dev-mode miner
(``local.py LocalMiner``, over ``payload/`` and ``pool/``), witness
generation (``witness.py generate_witness``) and stateless validation from a
witness alone (``stateless.py StatelessChain``, rooting on the card).
"""

from .sparse_root import SparseRootError, SparseRootTask
from .stateless import StatelessChain, StatelessValidationError, apply_output_to_trie
from .tree import EngineTree, ExecutedBlock, PayloadStatus
from .witness import ExecutionWitness, generate_witness

__all__ = ["EngineTree", "ExecutedBlock", "ExecutionWitness", "LocalMiner", "PayloadStatus",
           "SparseRootError", "SparseRootTask", "StatelessChain", "StatelessValidationError",
           "apply_output_to_trie", "generate_witness"]


def __getattr__(name: str):
    # ``local.py`` imports ``payload/``, whose builder imports this package's
    # tree: the miner loads on first use, so either package imports first
    if name == "LocalMiner":
        from .local import LocalMiner

        return LocalMiner
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
