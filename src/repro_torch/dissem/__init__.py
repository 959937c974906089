"""Dissemination-stability engine of the port (``engine``), the
byte-budget batch accumulator (``batcher``) and per-node replication
and ack byte accounting (``bandwidth``)."""
from .bandwidth import (ACK_BYTES, partition_size, per_node_bytes,
                        replication_bytes_per_node, uniform_traffic)

__all__ = ["ACK_BYTES", "partition_size", "per_node_bytes",
           "replication_bytes_per_node", "uniform_traffic"]
