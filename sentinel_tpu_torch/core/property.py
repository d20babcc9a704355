"""Dynamic property observer pattern.

Equivalent of the reference's SentinelProperty / DynamicSentinelProperty
(reference: sentinel-core/.../property/SentinelProperty.java,
DynamicSentinelProperty.java): rule managers register listeners on a
property; datasources push new values into it; ``update_value`` fans out
to listeners only when the value actually changed.
"""

from __future__ import annotations

import threading
from typing import Callable, Generic, List, Optional, TypeVar

T = TypeVar("T")


class PropertyListener(Generic[T]):
    """Reference: PropertyListener.java — configUpdate + configLoad."""

    def config_update(self, value: Optional[T]) -> None:
        raise NotImplementedError

    def config_load(self, value: Optional[T]) -> None:
        # Default: same as update (DynamicSentinelProperty.addListener fires
        # configLoad with the current value on registration).
        self.config_update(value)


class FuncListener(PropertyListener[T]):
    def __init__(self, fn: Callable[[Optional[T]], None]) -> None:
        self._fn = fn

    def config_update(self, value: Optional[T]) -> None:
        self._fn(value)


class SentinelProperty(Generic[T]):
    def add_listener(self, listener: PropertyListener[T]) -> None:
        raise NotImplementedError

    def remove_listener(self, listener: PropertyListener[T]) -> None:
        raise NotImplementedError

    def update_value(self, value: Optional[T]) -> bool:
        raise NotImplementedError


class DynamicSentinelProperty(SentinelProperty[T]):
    """Reference: DynamicSentinelProperty.java:30-80."""

    def __init__(self, value: Optional[T] = None) -> None:
        self._listeners: List[PropertyListener[T]] = []
        self._value: Optional[T] = value
        self._lock = threading.RLock()

    @property
    def value(self) -> Optional[T]:
        return self._value

    def add_listener(self, listener: PropertyListener[T]) -> None:
        with self._lock:
            self._listeners.append(listener)
            listener.config_load(self._value)

    def remove_listener(self, listener: PropertyListener[T]) -> None:
        with self._lock:
            if listener in self._listeners:
                self._listeners.remove(listener)

    def update_value(self, value: Optional[T]) -> bool:
        with self._lock:
            if self._value == value:
                return False
            self._value = value
            for listener in list(self._listeners):
                listener.config_update(value)
            return True

    def reset_value(self) -> None:
        """Forget the cached value WITHOUT notifying listeners: after
        an imperative clear (api.reset), a datasource re-push of the
        previously loaded config must fire again instead of being
        silently deduped as equal."""
        with self._lock:
            self._value = None


class NoOpSentinelProperty(SentinelProperty[T]):
    """Reference: NoOpSentinelProperty.java."""

    def add_listener(self, listener: PropertyListener[T]) -> None:
        pass

    def remove_listener(self, listener: PropertyListener[T]) -> None:
        pass

    def update_value(self, value: Optional[T]) -> bool:
        return False
