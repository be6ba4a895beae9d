"""Payload building: assemble blocks from the pool for the Engine API.

A copy of the JAX package's ``payload``: the one-shot builder and the payload
job service (``builder.py``) and the continuous producer (``producer.py``),
on the port's engine tree. Their catch-alls re-raise kernel faults
(``ops/_build.is_kernel_fault``) and count every other fallback.

Reference analogue: crates/payload — `PayloadBuilderService`/`PayloadJob`
(builder/src/service.rs), `BasicPayloadJobGenerator`
(basic/src/lib.rs:57), `EthereumPayloadBuilder` (crates/ethereum/payload).
"""

from .builder import PayloadAttributes, PayloadBuilderService, build_payload
from .producer import BlockProducer

__all__ = ["BlockProducer", "PayloadAttributes", "PayloadBuilderService",
           "build_payload"]
