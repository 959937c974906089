"""Wire-size constants of the HT-Paxos messages, and a batch's wire size.

Copies of the reference's ``core/network.py`` constants and
``core/htpaxos.py::batch_bytes``, which the byte-budget batcher and the
pipeline's byte accounting need.
"""
from __future__ import annotations

# Byte model of paper §5.2: 64 bytes of message overhead (IP header,
# Ethernet preamble/header/footer/gap, ARP, ...); request, batch, round
# and instance ids are 4 bytes each.
OVERHEAD = 64
ID_BYTES = 4


def batch_bytes(n_requests: int, request_bytes: int) -> int:
    """Wire size of ``<batch_id, batch>``: overhead + batch id + per
    request (request id + value)."""
    return OVERHEAD + ID_BYTES + n_requests * (ID_BYTES + request_bytes)
