"""Persistent ring buffer for prefill -> decode KV-cache handoff
(paper Section 3.2): fixed slot count, per-slot ready flags, pull-based
consumption. In the real system the slots live in GPU memory and are
published via HIP-IPC handles over XGMI; here each slot holds the actual
KV-cache tensors, already on the device (the consume step is a
device-to-device copy into the decode worker's batched cache).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, List, Optional


@dataclasses.dataclass
class RingSlot:
    ready: bool = False
    payload: Any = None          # (request, kv_cache pytree, first_token)


class KVRing:
    def __init__(self, n_slots: int = 32):
        self.slots: List[RingSlot] = [RingSlot() for _ in range(n_slots)]
        self._free: deque = deque(range(n_slots))
        self._ready: deque = deque()

    def try_put(self, payload) -> Optional[int]:
        """Publish a prefilled KV cache. None if the ring is full
        (backpressure on the prefill side)."""
        if not self._free:
            return None
        idx = self._free.popleft()
        self.slots[idx] = RingSlot(ready=True, payload=payload)
        self._ready.append(idx)
        return idx

    def try_pull(self):
        """Decode side pulls the oldest ready slot (None if empty)."""
        if not self._ready:
            return None
        idx = self._ready.popleft()
        slot = self.slots[idx]
        slot.ready = False
        payload = slot.payload
        slot.payload = None
        self._free.append(idx)
        return payload

    @property
    def n_ready(self) -> int:
        return len(self._ready)

    @property
    def n_free(self) -> int:
        return len(self._free)
