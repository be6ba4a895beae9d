"""Node assembly: wire storage, engine, pool, payload, RPC into one node.

Reference analogue: crates/node/builder — the typestate `NodeBuilder` →
components → add-ons → `EngineNodeLauncher::launch_node`
(src/launch/engine.rs:70), trimmed to the components that exist.

A copy of the JAX package's ``node/__init__.py`` over the port's node.
"""

from .node import Node, NodeConfig

__all__ = ["Node", "NodeConfig"]
