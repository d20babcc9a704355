"""Metric extension SPI: pluggable per-event metric callbacks (port of
``sentinel_tpu/metrics/extension.py``).

Reference: MetricExtension / AdvancedMetricExtension
(sentinel-core/.../metric/extension/MetricExtension.java) wired into the
StatisticSlot through MetricEntryCallback / MetricExitCallback. The engine
calls the registered extensions with each flush's verdicts: the same
callback surface, delivered a flush at a time.

Extensions run on the thread that fills the verdicts: keep them fast and
non-blocking; their exceptions are logged and swallowed.
"""

from __future__ import annotations

import threading
from typing import List, Sequence

from sentinel_tpu_torch.utils.record_log import record_log


class MetricExtension:
    """Callback surface (MetricExtension.java method-for-method; Python
    names snake_cased). Subclass and override what you need."""

    def add_pass(self, resource: str, n: int, *args: object) -> None:
        """Invocation passed all checks (n = acquire count)."""

    def add_block(
        self, resource: str, n: int, origin: str, block_error: object, *args: object
    ) -> None:
        """Invocation blocked; ``block_error`` is the BlockError."""

    def add_success(self, resource: str, n: int, *args: object) -> None:
        """Invocation completed successfully."""

    def add_exception(self, resource: str, n: int, throwable: object) -> None:
        """Business exception recorded (Tracer)."""

    def add_rt(self, resource: str, rt_ms: int, *args: object) -> None:
        """Response time recorded at completion."""

    def increase_thread_num(self, resource: str, *args: object) -> None:
        pass

    def decrease_thread_num(self, resource: str, *args: object) -> None:
        pass


class MetricExtensionProvider:
    """Registry (MetricExtensionProvider.java)."""

    _lock = threading.Lock()
    _extensions: List[MetricExtension] = []
    _spi_loaded = False

    @classmethod
    def get_extensions(cls) -> Sequence[MetricExtension]:
        """The registered extensions: those of :meth:`register` and, loaded
        once, the registry's ``MetricExtension`` providers."""
        if not cls._spi_loaded:
            cls._load_spi()
        return cls._extensions

    @classmethod
    def _load_spi(cls) -> None:
        with cls._lock:
            if cls._spi_loaded:
                return
            cls._spi_loaded = True
            try:
                from sentinel_tpu_torch.utils.registry import Registry

                for ext in Registry.of("MetricExtension").load_instance_list_sorted():
                    cls._extensions.append(ext)
            except Exception:
                record_log.error("[MetricExtension] SPI load failed", exc_info=True)

    @classmethod
    def register(cls, ext: MetricExtension) -> None:
        with cls._lock:
            cls._extensions.append(ext)

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._extensions.clear()
            cls._spi_loaded = False

    # ------------------------------------------------------------------
    # Batched dispatch helpers (called by the engine; one guard per
    # extension so one misbehaving extension cannot starve the rest).
    @staticmethod
    def _call(fn, *args) -> None:
        # Each callback is guarded independently: one throwing method
        # must not suppress the extension's other deliveries (e.g. a
        # failing add_rt skipping decrease_thread_num would drift the
        # extension's concurrency gauge forever).
        try:
            fn(*args)
        except Exception:
            record_log.error(
                "[MetricExtension] %s failed", getattr(fn, "__name__", fn),
                exc_info=True,
            )

    @classmethod
    def on_pass(cls, resource: str, n: int, args: Sequence[object]) -> None:
        for ext in cls.get_extensions():
            cls._call(ext.add_pass, resource, n, *args)
            cls._call(ext.increase_thread_num, resource, *args)

    @classmethod
    def on_blocked(
        cls, resource: str, n: int, origin: str, block_error: object,
        args: Sequence[object],
    ) -> None:
        for ext in cls.get_extensions():
            cls._call(ext.add_block, resource, n, origin, block_error, *args)

    @classmethod
    def on_complete(cls, resource: str, rt_ms: int, n: int, err: int) -> None:
        for ext in cls.get_extensions():
            cls._call(ext.add_rt, resource, rt_ms)
            cls._call(ext.add_success, resource, n)
            if err:
                cls._call(ext.add_exception, resource, err, None)
            cls._call(ext.decrease_thread_num, resource)
