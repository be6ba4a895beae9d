"""Engine (live tip): the sparse-trie state-root strategy.

Of the JAX package's ``engine`` the live tip's state-root job is ported:
``SparseRootTask`` (``sparse_root.py``), which streams a block's touched
keys, fetches multiproofs from the parent's database, reveals them into a
sparse trie and finishes on the card, and ``apply_output_to_trie``
(``stateless.py``), the delta it finishes with. The engine tree that drives
it, its strategy choice, the incremental fallback and the write-back of the
exported trie updates are not ported yet (ROADMAP A item 11); stateless
validation needs the EVM (A item 7).
"""

from .sparse_root import SparseRootError, SparseRootTask
from .stateless import StatelessValidationError, apply_output_to_trie

__all__ = ["SparseRootError", "SparseRootTask", "StatelessValidationError",
           "apply_output_to_trie"]
