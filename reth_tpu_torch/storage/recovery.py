"""Startup recovery's keys: what the engine tree writes for it.

A copy of the part of the JAX package's ``storage/recovery.py`` that the
engine tree uses: the durable unwind intent (``UNWIND_MARKER_KEY``), written
into ``Metadata`` before the first per-stage commit of a deep-reorg unwind
and cleared with the canonical-header surgery that ends it.

Not ported yet (ROADMAP A item 8): the recovery pass itself, which reads
the marker at boot and heals an interrupted unwind by completing it, with
the image, WAL and static-file hygiene around it.
"""

# durable unwind intent (engine/tree.py _unwind_persisted_to): written
# before the first per-stage unwind commit, cleared atomically with the
# canonical-header surgery — its presence at boot means a crash landed
# somewhere inside an unwind and names the exact target to finish at
UNWIND_MARKER_KEY = b"unwind_in_progress"
