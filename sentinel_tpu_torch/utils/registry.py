"""Plugin registry, the SPI equivalent (port of
``sentinel_tpu/utils/registry.py``).

The reference discovers implementations through a ``SpiLoader`` reading
``META-INF/services`` files, with ``@Spi(order, isSingleton, isDefault)``
metadata (sentinel-core/.../spi/SpiLoader.java:73,168,179 and
spi/Spi.java). Here: a registry keyed by interface with decorator
registration plus ``importlib.metadata`` entry-point discovery, with the
order, singleton and default semantics.

The entry-point group is ``sentinel_tpu_torch.<iface-name>``, not the JAX
package's ``sentinel_tpu.<iface-name>``: a plugin written for the JAX
package subclasses its classes, so loading it would import JAX.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Type

ENTRY_POINT_PREFIX = "sentinel_tpu_torch."


@dataclass(order=True)
class _Provider:
    order: int
    name: str = field(compare=False)
    factory: Callable[[], Any] = field(compare=False)
    singleton: bool = field(compare=False, default=True)
    is_default: bool = field(compare=False, default=False)
    _instance: Any = field(compare=False, default=None, repr=False)

    def get(self) -> Any:
        if not self.singleton:
            return self.factory()
        if self._instance is None:
            self._instance = self.factory()
        return self._instance


class Registry:
    """Per-interface provider table with sorted loading, as SpiLoader:
    ``load_instance_list_sorted()`` (SpiLoader.java:168),
    ``load_highest_priority_instance()`` (SpiLoader.java:179),
    ``load_default()`` and name lookup."""

    _registries: Dict[str, "Registry"] = {}
    _global_lock = threading.Lock()

    def __init__(self, iface: str) -> None:
        self.iface = iface
        self._providers: Dict[str, _Provider] = {}
        self._lock = threading.Lock()
        self._entry_points_loaded = False

    @classmethod
    def of(cls, iface: Any) -> "Registry":
        key = iface if isinstance(iface, str) else f"{iface.__module__}.{iface.__qualname__}"
        with cls._global_lock:
            reg = cls._registries.get(key)
            if reg is None:
                reg = cls(key)
                cls._registries[key] = reg
            return reg

    @classmethod
    def reset_all(cls) -> None:
        with cls._global_lock:
            cls._registries.clear()

    def register(self, factory: Callable[[], Any], *, name: Optional[str] = None, order: int = 0,
                 singleton: bool = True, default: bool = False) -> None:
        pname = name or getattr(factory, "__name__", repr(factory))
        with self._lock:
            self._providers[pname] = _Provider(order=order, name=pname, factory=factory, singleton=singleton,
                                               is_default=default)

    @property
    def entry_point_group(self) -> str:
        """The entry-point group this interface's plugins are found in."""
        return ENTRY_POINT_PREFIX + self.iface.rsplit(".", 1)[-1].lower()

    def _discover_entry_points(self) -> None:
        if self._entry_points_loaded:
            return
        self._entry_points_loaded = True
        try:
            from importlib.metadata import entry_points

            for ep in entry_points(group=self.entry_point_group):
                self.register(ep.load(), name=ep.name)
        except Exception:  # discovery is best effort, like SpiLoader's classpath scan
            pass

    def _sorted(self) -> List[_Provider]:
        self._discover_entry_points()
        with self._lock:
            return sorted(self._providers.values())

    def load_instance_list_sorted(self) -> List[Any]:
        return [p.get() for p in self._sorted()]

    def load_highest_priority_instance(self) -> Optional[Any]:
        ps = self._sorted()
        return ps[0].get() if ps else None

    def load_default(self) -> Optional[Any]:
        for p in self._sorted():
            if p.is_default:
                return p.get()
        return self.load_highest_priority_instance()

    def load_by_name(self, name: str) -> Optional[Any]:
        self._discover_entry_points()
        with self._lock:
            p = self._providers.get(name)
        return p.get() if p else None

    def names(self) -> List[str]:
        return [p.name for p in self._sorted()]


def provider(iface: Any, *, name: Optional[str] = None, order: int = 0, singleton: bool = True,
             default: bool = False) -> Callable[[Type], Type]:
    """Class decorator, ``@provider(ProcessorSlot, order=-7000)``: the
    reference's ``@Spi`` annotation (spi/Spi.java)."""

    def deco(cls: Type) -> Type:
        Registry.of(iface).register(cls, name=name or cls.__name__, order=order, singleton=singleton,
                                    default=default)
        return cls

    return deco
