"""Hash-partitioning of batch ids onto ordering groups.

The port's copy of the reference's router, without JAX:

  * ``route_id`` — python-level, for python batch ids (crc32 of
    ``repr(bid)``, the hash the discrete-event simulator routes with);
  * ``route_ids`` — vectorized over a tensor of uint32 ids (Knuth's
    multiplicative hash, the full 32-bit product folded before the
    modulus in version 2);
  * ``route_u32`` — its numpy twin, for host-side control-plane code.

The two hashes are different functions; each is stable on its own side.
``ROUTER_HASH_VERSION`` versions the multiplicative hash (version 1 kept
only the top 16 bits of the product; pass ``version=1`` for it).

``route_ids`` computes in ``int64``: torch ``int32`` shifts right
arithmetically and CPU torch ``uint32`` has no shift. The product is
split at bit 16 of the multiplier so that no partial product overflows
63 bits, and the low 32 bits are kept, as the reference's ``uint32``
product keeps them.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

_KNUTH = 2654435761  # 2^32 / golden ratio
_LOW32 = 0xFFFFFFFF

# Placement-function version. Bump only with a migration story: changing
# it re-homes every id in a live cluster.
ROUTER_HASH_VERSION = 2


def route_id(bid, groups: int) -> int:
    """Stable group of a python-level batch id (any reprable value)."""
    if groups <= 1:
        return 0
    return zlib.crc32(repr(bid).encode()) % groups


def route_ids(ids: torch.Tensor, groups: int, *,
              version: int = ROUTER_HASH_VERSION) -> torch.Tensor:
    """uint32 ids (an integer tensor holding their bits: ``int32`` with
    bit 31 set counts as ≥ 2^31) → int32 group of each id, on the ids'
    device."""
    x = ids.to(torch.int64) & _LOW32
    h = (x * (_KNUTH & 0xFFFF)
         + (((x * (_KNUTH >> 16)) & 0xFFFF) << 16)) & _LOW32
    if version == 1:
        h = h >> 16                     # legacy: top 16 bits only (biased)
    else:
        h = h ^ (h >> 16)               # fold the full 32-bit product
    return (h % groups).to(torch.int32)


def route_u32(ids, groups: int, *, version: int = ROUTER_HASH_VERSION)\
        -> np.ndarray:
    """Numpy twin of :func:`route_ids`: identical placement."""
    h = np.asarray(ids, dtype=np.uint32) * np.uint32(_KNUTH)
    if version == 1:
        h = h >> np.uint32(16)
    else:
        h = h ^ (h >> np.uint32(16))
    return (h % np.uint32(groups)).astype(np.int32)


def partition_ids(bids, groups: int) -> list[list]:
    """Split an iterable of python batch ids into per-group lists,
    preserving relative order within each group."""
    out: list[list] = [[] for _ in range(groups)]
    for bid in bids:
        out[route_id(bid, groups)].append(bid)
    return out
