"""The member mesh: a roster of devices for batch-parallel hashing, its
partition rules, sub-mesh leases and health mask, and the sharded keccak
front-end over it.

Port of the JAX package's ``parallel/`` (``mesh.py``). JAX's ``Mesh`` and
``NamedSharding`` have no counterpart here: a mesh is a tuple of roster
indices over a list of ``torch.device`` s, each member with its own CUDA
stream and its own replica of the digest buffer (``ops/fused_commit.py``
``FusedMeshEngine`` / ``SubtrieMeshEngine``). A roster may name one card
more than once.
"""

from .mesh import (
    DEFAULT_PARTITION_RULES,
    HashMesh,
    Mesh,
    MeshExhausted,
    MeshKeccak,
    match_partition_rule,
    mesh_tier,
    sharded_keccak,
)

__all__ = [
    "DEFAULT_PARTITION_RULES",
    "HashMesh",
    "Mesh",
    "MeshExhausted",
    "MeshKeccak",
    "match_partition_rule",
    "mesh_tier",
    "sharded_keccak",
]
