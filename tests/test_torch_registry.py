"""The port's SPI registry (sentinel_tpu_torch/utils/registry.py) against the
JAX package's, on the CPU: sorted loading, the default and the highest
priority, singletons, name lookup and the ``provider`` decorator on the
same registrations; ``InitFunc``s run once when ``get_engine`` builds the
engine; ``MetricExtension``s and ``ProcessorSlot``s are discovered through
the registry; and the port reads its own entry-point group,
``sentinel_tpu_torch.<iface>``, never the JAX package's (a plugin written
for the JAX package subclasses its classes: loading it would import JAX;
ROADMAP Queue 3 records the difference)."""

import importlib.metadata
from types import SimpleNamespace

import pytest

from sentinel_tpu.utils import registry as jreg
from sentinel_tpu_torch.utils import registry as treg

from torch_transport_env import pair  # noqa: F401

BOTH = [jreg, treg]


@pytest.fixture(autouse=True)
def _fresh_registries():
    for mod in BOTH:
        mod.Registry.reset_all()
    yield
    for mod in BOTH:
        mod.Registry.reset_all()


def _register(mod, iface):
    reg = mod.Registry.of(iface)
    made = []

    def factory(tag):
        def make():
            made.append(tag)
            return SimpleNamespace(tag=tag)

        make.__name__ = f"make_{tag}"
        return make

    reg.register(factory("late"), order=10)
    reg.register(factory("early"), order=-5, name="early")
    reg.register(factory("mid"), order=0, default=True)
    reg.register(factory("fresh"), order=3, singleton=False)
    return reg, made


@pytest.mark.parametrize("iface", ["Thing", SimpleNamespace])
def test_sorted_default_priority_and_singletons_match(iface, monkeypatch):
    monkeypatch.setattr(importlib.metadata, "entry_points", lambda group=None: [])
    out = []
    for mod in BOTH:
        reg, made = _register(mod, iface)
        first = [x.tag for x in reg.load_instance_list_sorted()]
        again = reg.load_instance_list_sorted()
        out.append((reg.iface, reg.names(), first, reg.load_default().tag, reg.load_highest_priority_instance().tag,
                    reg.load_by_name("early").tag, reg.load_by_name("nope"), again[0] is reg.load_by_name("early"),
                    again[2] is reg.load_by_name("make_fresh"), list(made)))
    assert out[0] == out[1]
    assert out[1][1] == ["early", "make_mid", "make_fresh", "make_late"]
    assert out[1][3] == "mid" and out[1][4] == "early"
    assert out[1][7] is True and out[1][8] is False  # singletons kept, a non-singleton made anew


def test_provider_decorator_matches():
    out = []
    for mod in BOTH:
        @mod.provider("Deco", order=-1, name="a")
        class A:
            pass

        @mod.provider("Deco", order=-2)
        class B:
            pass

        reg = mod.Registry.of("Deco")
        out.append((reg.names(), type(reg.load_highest_priority_instance()).__name__))
    assert out[0] == out[1] == (["B", "a"], "B")


def test_entry_point_group_is_the_ports_own(monkeypatch):
    """Discovery reads ``sentinel_tpu_torch.<iface>``; a plugin registered
    only under the JAX package's group is not loaded."""
    asked = []

    def entry_points(group=None):
        asked.append(group)
        eps = {
            "sentinel_tpu_torch.processorslot": [SimpleNamespace(name="torch-plugin", load=lambda: lambda: "T")],
            "sentinel_tpu.processorslot": [SimpleNamespace(name="jax-plugin", load=lambda: lambda: "J")],
        }
        return eps.get(group, [])

    monkeypatch.setattr(importlib.metadata, "entry_points", entry_points)
    reg = treg.Registry.of("ProcessorSlot")
    assert reg.entry_point_group == "sentinel_tpu_torch.processorslot"
    assert reg.load_instance_list_sorted() == ["T"] and reg.names() == ["torch-plugin"]
    assert asked == ["sentinel_tpu_torch.processorslot"]
    jr = jreg.Registry.of("ProcessorSlot")
    assert jr.load_instance_list_sorted() == ["J"]  # the JAX package keeps its group
    assert asked[-1] == "sentinel_tpu.processorslot"


def test_broken_entry_points_are_best_effort(monkeypatch):
    def entry_points(group=None):
        raise RuntimeError("broken metadata")

    monkeypatch.setattr(importlib.metadata, "entry_points", entry_points)
    for mod in BOTH:
        reg = mod.Registry.of("Broken")
        reg.register(lambda: 1, name="one")
        assert reg.load_instance_list_sorted() == [1]


def test_init_funcs_run_once_at_get_engine(pair):
    """An InitFunc (a callable, or an object with ``init``) runs once, when
    ``get_engine`` builds the engine, before the rules are re-applied."""
    out = []
    for p in pair.sides:
        ran = []

        class WithInit:
            def init(self):
                ran.append(("obj", p.api.peek_engine() is None))

        reg = p.registry.Registry.of("InitFunc")
        reg.register(WithInit, order=1)
        reg.register(lambda: (lambda: ran.append(("fn", True))), name="fn", order=0)
        reg.register(lambda: (lambda: 1 / 0), name="raises", order=2)  # logged, boot goes on
        prev = p.api.set_engine(None)
        try:
            eng = p.api.get_engine()
            p.api.get_engine()
            out.append(list(ran))
        finally:
            p.api.set_engine(prev)
            eng.close()
    assert out[0] == out[1] == [("fn", True), ("obj", True)]


def test_metric_extensions_are_discovered(pair):
    """A MetricExtension registered in the registry is loaded once and
    receives the fill's calls; explicit registration still works."""
    out = []
    for p in pair.sides:
        ext_mod = p.extension
        calls = []

        class Rec(ext_mod.MetricExtension):
            def __init__(self, tag):
                self.tag = tag

            def add_pass(self, resource, n, *args):
                calls.append((self.tag, "pass", resource, n))

            def add_block(self, resource, n, origin, block_error, *args):
                calls.append((self.tag, "block", resource, n, type(block_error).__name__))

        ext_mod.MetricExtensionProvider.clear()
        p.registry.Registry.of("MetricExtension").register(lambda: Rec("spi"), name="rec")
        ext_mod.MetricExtensionProvider.register(Rec("explicit"))
        p.st.flow_rule_manager.load_rules([p.st.FlowRule("m", count=1)])
        p.clock.set_ms(100)
        p.st.try_entry("m")
        p.st.try_entry("m")
        out.append((sorted(calls), len(ext_mod.MetricExtensionProvider.get_extensions())))
        ext_mod.MetricExtensionProvider.clear()
    assert out[0] == out[1]
    assert out[1][1] == 2 and ("spi", "pass", "m", 1) in out[1][0]


def test_processor_slots_are_discovered(pair):
    """A ProcessorSlot registered in the registry joins the chain."""
    out = []
    for p in pair.sides:
        class Deny(p.slots.ProcessorSlot):
            name = "deny"

            def entry(self, ctx):
                return "denied" if ctx.resource == "spi" else None

        p.slots.SlotChainRegistry.clear()
        p.registry.Registry.of("ProcessorSlot").register(Deny, name="deny")
        with pytest.raises(p.E.CustomBlockError) as ei:
            p.st.entry("spi")
        out.append((ei.value.slot_name, ei.value.rule, [s.name for s in p.slots.SlotChainRegistry.slots()]))
        p.slots.SlotChainRegistry.clear()
    assert out[0] == out[1] == ("deny", "denied", ["deny"])
