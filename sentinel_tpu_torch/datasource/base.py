"""Datasource abstractions (port of ``sentinel_tpu/datasource/base.py``).

Reference mapping (sentinel-extension/sentinel-datasource-extension):

* :class:`ReadableDataSource` ≙ ReadableDataSource.java:28-44 —
  ``load_config`` / ``read_source`` / ``get_property``.
* :class:`AbstractDataSource` ≙ AbstractDataSource.java:29-48 — holds a
  DynamicSentinelProperty and a converter.
* :class:`AutoRefreshDataSource` ≙ AutoRefreshDataSource.java:32-69 —
  poll ``read_source`` on a timer, push changes into the property.
* :class:`PushDataSource` — the shape every push-style adapter
  (nacos/zookeeper/apollo/etcd/redis/consul/eureka in the reference)
  reduces to: an external client calls ``on_update(raw)``.
* :class:`WritableDataSource` / :class:`WritableDataSourceRegistry` ≙
  WritableDataSource.java + transport-common's
  WritableDataSourceRegistry — the command plane persists rule
  modifications through these.
"""

from __future__ import annotations

import json
import threading
from typing import Callable, Generic, List, Optional, Sequence, TypeVar

from sentinel_tpu_torch.core.property import DynamicSentinelProperty, SentinelProperty
from sentinel_tpu_torch.utils.record_log import record_log

S = TypeVar("S")  # source (raw) type
T = TypeVar("T")  # target (rules) type

Converter = Callable[[S], T]

# Shared response-size stance for every network source: a corrupted or
# hostile peer must not balloon memory.
DEFAULT_MAX_BODY_BYTES = 16 * 1024 * 1024


def read_capped(resp, max_bytes: int = DEFAULT_MAX_BODY_BYTES) -> bytes:
    """Read an HTTP response body, raising when it exceeds the cap."""
    data = resp.read(max_bytes + 1)
    if len(data) > max_bytes:
        raise ValueError("response exceeds size cap")
    return data


def join_clean(thread, timeout: float, name: str) -> bool:
    """Join a watcher thread on close; returns True when it actually
    stopped. A ``join(timeout=…)`` that expires leaks a LIVE daemon
    thread — every source logs that loudly and flips its
    ``closed_dirty`` flag instead of pretending the shutdown was
    clean (a stuck thread can still touch sockets, callbacks and the
    rule property after "close")."""
    if thread is None:
        return True
    thread.join(timeout=timeout)
    if thread.is_alive():
        record_log.warn(
            "[%s] watcher thread did not stop within %.1fs; a live "
            "thread leaked (closed_dirty=True)", name, timeout,
        )
        return False
    return True


def json_converter(rule_cls: type) -> Converter[str, List]:
    """Raw JSON string -> list of rules of ``rule_cls`` (accepts the
    reference's camelCase field names; see models.rules.rules_from_json)."""

    def convert(raw: str):
        from sentinel_tpu_torch.models.rules import rules_from_json

        if raw is None or not str(raw).strip():
            return []
        data = json.loads(raw)
        if not isinstance(data, list):
            data = [data]
        return rules_from_json(data, rule_cls)

    return convert


class ReadableDataSource(Generic[S, T]):
    def load_config(self) -> Optional[T]:
        raise NotImplementedError

    def read_source(self) -> Optional[S]:
        raise NotImplementedError

    def get_property(self) -> SentinelProperty:
        raise NotImplementedError

    def close(self) -> None:
        pass


class AbstractDataSource(ReadableDataSource[S, T]):
    def __init__(self, converter: Converter[S, T]) -> None:
        self.converter = converter
        self.property: DynamicSentinelProperty = DynamicSentinelProperty()

    def load_config(self, source: Optional[S] = None) -> Optional[T]:
        if source is None:
            source = self.read_source()
        if source is None:
            return None
        return self.converter(source)

    def get_property(self) -> SentinelProperty:
        return self.property


class AutoRefreshDataSource(AbstractDataSource[S, T]):
    """Polls ``read_source`` every ``refresh_interval_sec`` on a daemon
    thread; subclasses may override ``is_modified`` to cheapen polls."""

    def __init__(self, converter: Converter[S, T], refresh_interval_sec: float = 3.0) -> None:
        super().__init__(converter)
        self.refresh_interval = refresh_interval_sec
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "AutoRefreshDataSource":
        self.refresh()  # initial load (AbstractDataSource firstLoad)
        self._thread = threading.Thread(
            target=self._loop, name="sentinel-datasource-refresh", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.refresh_interval):
            try:
                self.refresh()
            except Exception:
                record_log.error("[AutoRefreshDataSource] refresh failed", exc_info=True)

    def is_modified(self) -> bool:
        return True

    def refresh(self) -> bool:
        """One poll: read, convert, push. Returns True when updated."""
        if not self.is_modified():
            return False
        try:
            value = self.load_config()
        except Exception:
            record_log.error("[AutoRefreshDataSource] load failed", exc_info=True)
            return False
        return self.property.update_value(value)

    def close(self) -> None:
        self._stop.set()


class PushDataSource(AbstractDataSource[S, T]):
    """Base for watch/subscription-style sources: the external client's
    callback delivers raw payloads to :meth:`on_update` (the shape of
    every reference datasource adapter's listener)."""

    def read_source(self) -> Optional[S]:
        return None

    def on_update(self, raw: Optional[S]) -> bool:
        try:
            value = self.converter(raw) if raw is not None else None
        except Exception:
            record_log.error("[PushDataSource] convert failed", exc_info=True)
            return False
        return self.property.update_value(value)


class WritableDataSource(Generic[T]):
    """Reference: WritableDataSource.java — ``write(value)``."""

    def write(self, value: T) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryDataSource(AbstractDataSource[S, T], WritableDataSource[S]):
    """Both sides in memory — handy for tests and embedding."""

    def __init__(self, converter: Converter[S, T], initial: Optional[S] = None) -> None:
        super().__init__(converter)
        self._raw = initial
        if initial is not None:
            self.property.update_value(self.load_config(initial))

    def read_source(self) -> Optional[S]:
        return self._raw

    def write(self, value: S) -> None:
        self._raw = value
        self.property.update_value(self.load_config(value))


class WritableDataSourceRegistry:
    """Where the command plane finds the writer for each rule kind
    (reference: transport-common WritableDataSourceRegistry)."""

    _lock = threading.Lock()
    _sources: dict = {}

    @classmethod
    def register(cls, kind: str, source: WritableDataSource) -> None:
        with cls._lock:
            cls._sources[kind] = source

    @classmethod
    def get(cls, kind: str) -> Optional[WritableDataSource]:
        with cls._lock:
            return cls._sources.get(kind)

    @classmethod
    def try_write(cls, kind: str, value) -> bool:
        src = cls.get(kind)
        if src is None:
            return False
        try:
            src.write(value)
            return True
        except Exception:
            record_log.error("[WritableDataSourceRegistry] write failed", exc_info=True)
            return False

    @classmethod
    def clear(cls) -> None:
        with cls._lock:
            cls._sources.clear()
