"""P2P networking: eth-wire messages, peer sessions, sync downloaders.

Reference analogue: crates/net — eth-wire message types/codecs
(eth-wire-types), the session/server machinery (network), download
abstractions (p2p) and the reverse-headers/bodies downloaders
(downloaders). Transport here is length-prefixed frames over TCP; the
RLPx layer is fully encrypted: EIP-8 ECIES handshake (validated against
the EIP's own vectors in tests/test_external_vectors.py) and AES-256-CTR
frames with keccak ingress/egress MACs (net/rlpx.py).

A copy of the JAX package's ``net/``. AES comes from the port's own
``csrc/aes.cpp`` (``_aes.py``, built with g++ at first use), never from the
``cryptography`` package. The snap/1 server and the downloaders root on
``device`` (the card unless ``device="cpu"``): kernel 1 for range proofs and
body roots, the offline stages' kernels after an online sync.
"""

from .wire import (
    EthMessage,
    MessageId,
    Status,
    decode_message,
    encode_message,
)
from .p2p import PeerConnection
from .server import NetworkManager
from .downloader import (
    BodiesDownloader,
    FullBlockClient,
    download_headers_reverse,
    sync_from_peer,
)

__all__ = [
    "EthMessage",
    "MessageId",
    "Status",
    "decode_message",
    "encode_message",
    "PeerConnection",
    "NetworkManager",
    "sync_from_peer",
    "BodiesDownloader",
    "FullBlockClient",
    "download_headers_reverse",
]
