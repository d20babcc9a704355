"""String→row interning.

The reference keys everything by resource-name strings and caches wrapper
objects per string (reference: sentinel-core/.../CtSph.java:206-233 chain
map capped at MAX_SLOT_CHAIN_SIZE=6000; context/ContextUtil.java:129-190
capped at MAX_CONTEXT_NAME_SIZE=2000; Constants.java:36-37). In the batched engine every
named thing must become a **stable integer row id** into the counter
tensors. The interner assigns dense ids, enforces the same capacity-cap
semantics (returning ``None`` above cap → callers degrade to pass-through,
exactly like CtSph returning a no-op chain), and keeps the reverse map
for the command/metric plane.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple


class Interner:
    def __init__(self, capacity: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._to_id: Dict[str, int] = {}
        self._to_name: List[str] = []
        self.capacity = capacity

    def intern(self, name: str) -> Optional[int]:
        """Return the id for ``name``, assigning one if new.

        Returns ``None`` if at capacity — the caller must treat the
        resource as unprotected (pass-through), mirroring
        CtSph.lookProcessChain's null return above the 6000-chain cap.
        """
        with self._lock:
            i = self._to_id.get(name)
            if i is not None:
                return i
            if self.capacity is not None and len(self._to_name) >= self.capacity:
                return None
            i = len(self._to_name)
            self._to_id[name] = i
            self._to_name.append(name)
            return i

    def lookup(self, name: str) -> Optional[int]:
        with self._lock:
            return self._to_id.get(name)

    def name_of(self, i: int) -> str:
        with self._lock:
            return self._to_name[i]

    def __len__(self) -> int:
        with self._lock:
            return len(self._to_name)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._to_id

    def items(self) -> Iterator[Tuple[str, int]]:
        with self._lock:
            snapshot = list(self._to_id.items())
        return iter(snapshot)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._to_name)

    def clear(self) -> None:
        with self._lock:
            self._to_id.clear()
            self._to_name.clear()


class PairInterner:
    """Interns (a_id, b_id) pairs — e.g. (resource, context) for
    per-context DefaultNode rows or (resource, origin) for origin nodes
    (reference: NodeSelectorSlot.java:127-186, ClusterBuilderSlot.java:49).
    """

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._lock = threading.Lock()
        self._to_id: Dict[Tuple[int, int], int] = {}
        self._pairs: List[Tuple[int, int]] = []
        self.capacity = capacity

    def intern(self, a: int, b: int) -> Optional[int]:
        key = (a, b)
        with self._lock:
            i = self._to_id.get(key)
            if i is not None:
                return i
            if self.capacity is not None and len(self._pairs) >= self.capacity:
                return None
            i = len(self._pairs)
            self._to_id[key] = i
            self._pairs.append(key)
            return i

    def lookup(self, a: int, b: int) -> Optional[int]:
        with self._lock:
            return self._to_id.get((a, b))

    def pair_of(self, i: int) -> Tuple[int, int]:
        with self._lock:
            return self._pairs[i]

    def items(self) -> Iterator[Tuple[Tuple[int, int], int]]:
        with self._lock:
            snapshot = list(self._to_id.items())
        return iter(snapshot)

    def __len__(self) -> int:
        with self._lock:
            return len(self._pairs)

    def clear(self) -> None:
        with self._lock:
            self._to_id.clear()
            self._pairs.clear()
