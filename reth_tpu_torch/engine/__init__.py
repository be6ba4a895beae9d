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

Not ported yet (ROADMAP A): ``local.py`` (it needs ``payload/``), stateless
validation (``stateless.py WitnessStateSource`` / ``StatelessChain``) and
``witness.py``.
"""

from .sparse_root import SparseRootError, SparseRootTask
from .stateless import StatelessValidationError, apply_output_to_trie
from .tree import EngineTree, ExecutedBlock, PayloadStatus

__all__ = ["EngineTree", "ExecutedBlock", "PayloadStatus", "SparseRootError",
           "SparseRootTask", "StatelessValidationError", "apply_output_to_trie"]
