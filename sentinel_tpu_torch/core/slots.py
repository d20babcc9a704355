"""Pluggable processor slots, the custom half of the slot chain (port of
``sentinel_tpu/core/slots.py``).

The reference assembles the slot chain by SPI
(slots/DefaultSlotChainBuilder.java:36-57 + META-INF/services), so a user
can insert a ProcessorSlot anywhere by order. In the batched design the
built-in slots are fused into the device step (runtime/flush.py); a user
slot cannot run between its kernels, but the chain is open at the host
boundary:

* a registered :class:`ProcessorSlot`'s ``entry`` runs for every entry op
  at flush time, before the device chain (the position of a first-in-chain
  custom slot); a veto clears the entry's authority column, so K4 blocks
  it and K2 counts the block in the windows, and the fill attributes it
  (``BLOCK_CUSTOM``, the slot's name, the veto as ``blocked_rule``);
* ``exit`` runs for every completed invocation in the flush that carries
  its exit op (the chain's exit traversal).

Slots run on the flushing thread under the flush lock, as the reference's
run inline on the request thread: keep them fast. Custom slots run in
``order`` ascending (negative = earlier), as @Spi(order).
"""

from __future__ import annotations

import threading
from typing import List, NamedTuple, Optional, Sequence, Tuple

from sentinel_tpu_torch.utils.record_log import record_log


class SlotEntryContext(NamedTuple):
    """What a custom slot sees of one entry op (the host view of
    (context, resourceWrapper, count, args))."""

    resource: str
    context_name: str
    origin: str
    acquire: int
    prio: bool
    args: Tuple[object, ...]


class ProcessorSlot:
    """Subclass and register through :class:`SlotChainRegistry` (or the
    registry's ``ProcessorSlot`` interface)."""

    name: str = ""
    order: int = 0

    def entry(self, ctx: SlotEntryContext) -> Optional[object]:
        """None passes; any other value vetoes the entry (the value is the
        verdict's ``blocked_rule``)."""
        return None

    def exit(self, resource: str, rt_ms: int, count: int, err: int) -> None:
        """The invocation completed (the exit traversal)."""


class SlotChainRegistry:
    """The host-side DefaultSlotChainBuilder: explicit registration plus
    the registry's ``ProcessorSlot`` providers, sorted by ``order``."""

    _lock = threading.Lock()
    # Copy on write: readers iterate the list object they took; writers
    # build a new sorted list and swap the reference, so a flush in the
    # middle of an iteration never sees an in-place reorder (the COW map
    # of the reference's chain cache, CtSph.java:224-228).
    _slots: List[ProcessorSlot] = []
    _spi_loaded = False

    @classmethod
    def slots(cls) -> Sequence[ProcessorSlot]:
        if not cls._spi_loaded:
            cls._load_spi()
        return cls._slots

    @classmethod
    def _load_spi(cls) -> None:
        with cls._lock:
            if cls._spi_loaded:
                return
            loaded: List[ProcessorSlot] = []
            try:
                from sentinel_tpu_torch.utils.registry import Registry

                loaded = list(Registry.of("ProcessorSlot").load_instance_list_sorted())
            except Exception:
                record_log.error("[SlotChain] SPI load failed", exc_info=True)
            cls._slots = sorted(cls._slots + loaded, key=lambda s: s.order)
            cls._spi_loaded = True  # after the list: no reader sees a gap

    @classmethod
    def register(cls, slot: ProcessorSlot) -> None:
        with cls._lock:
            cls._slots = sorted(cls._slots + [slot], key=lambda s: s.order)

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._slots = []
            cls._spi_loaded = False

    # ------------------------------------------------------------------
    @classmethod
    def check_entry(cls, ctx: SlotEntryContext):
        """Every slot's entry check in order; the first veto wins. Returns
        (slot, veto) or None. A raising slot is skipped (fail open, as an
        unexpected non-Block exception in the chain: LogSlot.java:26-28
        logs and continues)."""
        for slot in cls.slots():
            try:
                veto = slot.entry(ctx)
            except Exception:
                record_log.error("[SlotChain] slot %s entry failed", slot.name or type(slot).__name__,
                                 exc_info=True)
                continue
            if veto is not None:
                return slot, veto
        return None

    @classmethod
    def check_bulk_entry(cls, g) -> None:
        """The entry checks of one bulk group, once per distinct acquire
        value (the only per-entry field a slot sees on the bulk path),
        vetoing exactly the matching entries through ``g.custom_veto`` and
        ``g.custom_veto_mask``. The one home of the bulk veto rule, shared
        by the device path (``Engine._run_chunk``), the degraded fill
        (``failover.fill_degraded``) and the speculative tier. A no-op on
        a group already checked (``custom_checked``: a pass leaves both
        veto fields None)."""
        import numpy as np

        if g.custom_checked or g.custom_veto is not None or g.custom_veto_mask is not None:
            return
        vetoed_vals = []
        for a in np.unique(g.acquire):
            veto = cls.check_entry(SlotEntryContext(g.resource, g.context_name, g.origin, int(a), False, ()))
            if veto is not None:
                if g.custom_veto is None:
                    g.custom_veto = veto
                vetoed_vals.append(int(a))
        if vetoed_vals:
            g.custom_veto_mask = np.isin(g.acquire, vetoed_vals)
        g.custom_checked = True

    @classmethod
    def on_exit(cls, resource: str, rt_ms: int, count: int, err: int) -> None:
        for slot in cls.slots():
            try:
                slot.exit(resource, rt_ms, count, err)
            except Exception:
                record_log.error("[SlotChain] slot %s exit failed", slot.name or type(slot).__name__,
                                 exc_info=True)
