"""The port's custom processor slots (sentinel_tpu_torch/core/slots.py and
the engine's, the degraded fill's and the speculative tier's hooks) against
the JAX package's, on the CPU.

The cases of tests/test_custom_slots.py run on both packages' global
engines: a veto blocks with attribution (``CustomBlockError.slot_name`` and
``.rule``) and is counted in the windows, arguments admit, exits are
observed, other resources pass, the first veto in slot order wins, a
raising slot fails open, and the veto reaches the block log.

Then one stream in lockstep (tests/torch_lockstep.py) on five routes: the
device path at depth 0 and 2, the degraded fill at depth 0 and 2 (one
injected fetch fault, no recovery) and the speculative tier. Three slots
are registered: one vetoes a resource's singles unless their first arg is
"paid", one vetoes bulk entries of acquire 2 on even resources (checked
once per distinct acquire of a group), one raises on one resource (it
fails open); the slots count their calls and record the exits they see.
After every flush the verdicts (reason, wait_ms, slot name, the blocking
rule or veto, the degraded and speculative marks), the bulk groups' arrays,
every state tensor, the slots' calls and exits must be equal."""

import numpy as np
import pytest

from torch_lockstep import run_lockstep
from torch_transport_env import module_of, pair  # noqa: F401


def _slots_mod(lib):
    return module_of(lib, "core.slots")


def _make_slots(mod):
    """The stream's three slots, each recording what it saw."""
    seen = {"calls": [], "exits": []}

    class Paywall(mod.ProcessorSlot):
        name, order = "paywall", -100

        def entry(self, ctx):
            seen["calls"].append(("paywall", ctx.resource, ctx.acquire, ctx.prio, tuple(ctx.args)))
            if ctx.resource == "premium" and (not ctx.args or ctx.args[0] != "paid"):
                return {"reason": "payment required"}
            return None

        def exit(self, resource, rt_ms, count, err):
            seen["exits"].append((resource, int(rt_ms), int(count), int(err)))

    class Acquire2(mod.ProcessorSlot):
        name, order = "acquire2", 5

        def entry(self, ctx):
            seen["calls"].append(("acquire2", ctx.resource, ctx.acquire))
            if ctx.resource.startswith("b") and int(ctx.resource[1:]) % 2 == 0 and ctx.acquire == 2:
                return True  # a veto with no rule to attribute
            return None

    class Broken(mod.ProcessorSlot):
        name, order = "broken", 0

        def entry(self, ctx):
            if ctx.resource == "b3":
                raise RuntimeError("slot bug")
            return None

    return seen, [Acquire2(), Broken(), Paywall()]


def _vrec(v):
    if v is None:
        return None
    rule = v.blocked_rule
    rule = rule.to_dict() if hasattr(rule, "to_dict") else rule
    return (bool(v.admitted), int(v.reason), int(v.wait_ms), v.limit_type, v.slot_name, bool(v.degraded),
            bool(v.speculative), rule)


ROUTES = {
    "device": dict(depth=0),
    "depth2": dict(depth=2),
    "degraded": dict(depth=0, degraded=True),
    "degraded_depth2": dict(depth=2, degraded=True),
    "speculative": dict(depth=0, spec=True),
}


def _stream(lib, depth, degraded=False, spec=False, steps=6, seed=3):
    mod = _slots_mod(lib)
    mod.SlotChainRegistry.clear()
    seen, slots = _make_slots(mod)
    for s in slots:
        mod.SlotChainRegistry.register(s)
    try:
        eng = lib.mk(depth=depth, FAILOVER_ENABLED="true" if degraded else "false", FAILOVER_CHECKPOINT_EVERY=1,
                     FAILOVER_RETRY_MS=10**9, SPECULATIVE_ENABLED="true" if spec else "false",
                     SPECULATIVE_FLUSH_BATCH=10000, SPECULATIVE_OVERADMIT_MAX=0)
        st = lib.st
        eng.set_flow_rules([st.FlowRule("premium", count=6)] + [st.FlowRule(f"b{i}", count=9 + i) for i in range(6)])
        rng = np.random.default_rng(seed)
        obs = []
        held = []
        inj = None
        for step in range(steps):
            now = 1000 + 200 * step
            lib.clock.set_ms(now)
            if degraded and step == 1:
                inj = lib.FaultInjector().install(eng)
                inj.fail_fetch(eng.flush_seq + 1)
            ops = []
            for j in range(5):
                args = ("paid",) if rng.random() < 0.5 else ("free",)
                res = "premium" if j % 2 == 0 else f"b{int(rng.integers(0, 6))}"
                if spec:
                    op, _v = eng.entry_sync(res, args=args)
                else:
                    op = eng.submit_entry(res, args=args)
                ops.append(op)
            groups = []
            for b in range(4):
                n = int(rng.integers(2, 9))
                acq = rng.integers(1, 3, n).astype(np.int32)
                groups.append(eng.submit_bulk(f"b{b}", n, ts=now, acquire=acq))
            for op, rt in held:
                eng.submit_exit(op.rows, rt=rt, ts=now, resource=op.resource)
            eng.flush()
            rec = [_vrec(op.verdict) for op in ops]
            rec += [(g.admitted, g.reason, g.wait_ms) for g in groups]
            held = [(op, int(rng.integers(1, 50))) for op in ops if op.verdict.admitted]
            for g in groups:
                if g.admitted_count:
                    eng.submit_exit_bulk(g.rows, g.admitted_count, rt=7, ts=now, resource=g.resource)
            obs.append((rec, lib.states(eng)))
        eng.flush()
        eng.drain()
        obs.append(lib.states(eng))
        obs.append((eng.failover.state, sorted(seen["calls"], key=repr), seen["exits"]))
        if inj is not None:
            inj.clear()
        return obs
    finally:
        mod.SlotChainRegistry.clear()


@pytest.mark.parametrize("route", list(ROUTES))
def test_slot_stream_in_lockstep(route):
    obs = run_lockstep(lambda lib: _stream(lib, **ROUTES[route]))
    state, calls, exits = obs[-1]
    assert state == ("DEGRADED" if "degraded" in route else "HEALTHY")
    reasons = [r for rec, _s in obs[:-2] for r in rec if isinstance(r, list) and len(r) == 8]
    assert any(r[1] == 6 and r[4] == "paywall" for r in reasons)  # BLOCK_CUSTOM, attributed
    # The exit traversal runs in the device fill; a degraded fill calls no
    # slot's exit (in both packages), and here every exit flush is degraded.
    assert bool(exits) is ("degraded" not in route)


def test_slot_stream_counts_custom_blocks_in_the_windows():
    """A vetoed single is a block in the resource's windows, on both."""

    def scenario(lib):
        mod = _slots_mod(lib)
        mod.SlotChainRegistry.clear()
        seen, slots = _make_slots(mod)
        mod.SlotChainRegistry.register(slots[2])
        try:
            eng = lib.mk()
            eng.set_flow_rules([lib.st.FlowRule("premium", count=100)])
            lib.clock.set_ms(100)
            ops = [eng.submit_entry("premium", args=(a,)) for a in ("free", "paid", "free")]
            eng.flush()
            return [_vrec(op.verdict) for op in ops], eng.cluster_node_stats("premium"), seen["calls"]
        finally:
            mod.SlotChainRegistry.clear()

    verdicts, stats, calls = run_lockstep(scenario)
    assert [v[0] for v in verdicts] == [False, True, False]
    assert stats["block_qps"] == 2.0 and stats["pass_qps"] == 1.0 and len(calls) == 3


# --- the cases of tests/test_custom_slots.py, through both global engines -----


def _paywall(p):
    class PaywallSlot(p.slots.ProcessorSlot):
        name, order = "paywall", -100

        def __init__(self):
            self.exits = []

        def entry(self, ctx):
            if ctx.resource == "premium" and (not ctx.args or ctx.args[0] != "paid"):
                return {"reason": "payment required"}
            return None

        def exit(self, resource, rt_ms, count, err):
            self.exits.append((resource, rt_ms, count, err))

    return PaywallSlot()


def test_veto_blocks_with_attribution(pair):
    got = []
    for p in pair.sides:
        p.slots.SlotChainRegistry.register(_paywall(p))
        p.st.flow_rule_manager.load_rules([p.st.FlowRule("premium", count=100)])
        p.clock.set_ms(100)
        with pytest.raises(p.E.CustomBlockError) as ei:
            p.st.entry("premium")
        stats = p.engine.cluster_node_stats("premium")
        got.append((ei.value.slot_name, ei.value.rule, stats["block_qps"], stats["pass_qps"]))
    assert got[0] == got[1] == ("paywall", {"reason": "payment required"}, 1.0, 0.0)


def test_args_admit_and_exit_observed(pair):
    got = []
    for p in pair.sides:
        slot = _paywall(p)
        p.slots.SlotChainRegistry.register(slot)
        p.clock.set_ms(100)
        e = p.st.entry("premium", args=("paid",))
        p.clock.set_ms(130)
        e.exit()
        p.engine.flush()
        got.append(slot.exits)
    assert got[0] == got[1] == [("premium", 30, 1, 0)]


def test_other_resources_unaffected(pair):
    for p in pair.sides:
        p.slots.SlotChainRegistry.register(_paywall(p))
        assert p.st.try_entry("free") is not None


def test_slot_order_first_veto_wins(pair):
    names = []
    for p in pair.sides:
        class A(p.slots.ProcessorSlot):
            name, order = "a", 10

            def entry(self, ctx):
                return "a-veto"

        class B(p.slots.ProcessorSlot):
            name, order = "b", -10

            def entry(self, ctx):
                return "b-veto"

        p.slots.SlotChainRegistry.register(A())
        p.slots.SlotChainRegistry.register(B())
        with pytest.raises(p.E.CustomBlockError) as ei:
            p.st.entry("x")
        names.append((ei.value.slot_name, ei.value.rule))
    assert names[0] == names[1] == ("b", "b-veto")  # the lower order runs first


def test_raising_slot_fails_open(pair):
    for p in pair.sides:
        class Broken(p.slots.ProcessorSlot):
            name = "broken"

            def entry(self, ctx):
                raise RuntimeError("slot bug")

        p.slots.SlotChainRegistry.register(Broken())
        assert p.st.try_entry("y") is not None  # fail open, as the chain


def test_veto_appears_in_block_log(pair, tmp_path):
    rows = []
    for p in pair.sides:
        bl = __import__(f"{p.name}.metrics.block_log", fromlist=["x"])
        p.engine.block_log = bl.BlockLogger(base_dir=str(tmp_path / p.name), clock=p.clock)
        p.slots.SlotChainRegistry.register(_paywall(p))
        p.clock.set_ms(100)
        assert p.st.try_entry("premium") is None
        p.engine.block_log.flush()
        (_, key, count), = p.engine.block_log.read_entries()
        rows.append((tuple(key), count))
    assert rows[0] == rows[1] and rows[1][0][:2] == ("premium", "CustomBlockException") and rows[1][1] == 1


def test_bulk_veto_once_per_distinct_acquire(pair):
    """check_bulk_entry: one check per distinct acquire, exactly the
    matching rows vetoed (BLOCK_CUSTOM), the group checked once."""
    out = []
    for p in pair.sides:
        calls = []

        class Two(p.slots.ProcessorSlot):
            name = "two"

            def entry(self, ctx):
                calls.append(ctx.acquire)
                return "no twos" if ctx.acquire == 2 else None

        p.slots.SlotChainRegistry.register(Two())
        p.st.flow_rule_manager.load_rules([p.st.FlowRule("g", count=100)])
        p.clock.set_ms(100)
        acq = np.array([1, 2, 2, 3, 1, 2], dtype=np.int32)
        g = p.engine.submit_bulk("g", 6, acquire=acq)
        p.engine.flush()
        out.append((g.admitted.tolist(), g.reason.tolist(), sorted(calls), g.custom_checked,
                    g.custom_veto[1], g.custom_veto_mask.tolist()))
    assert out[0] == out[1]
    assert out[1][1] == [0, 6, 6, 0, 0, 6] and out[1][2] == [1, 2, 3]


def _captured(lib, depth, tmp):
    """The slot stream with the capture journal armed, decoded with the JAX
    reader; and the BLOCK_CUSTOM reasons among the journal's verdicts."""
    import os
    import shutil

    from test_torch_capture import _decoded_stream

    d = os.path.join(tmp, "cap")  # one path for both: the header's config names it
    with lib.config._lock:
        lib.config._runtime.clear()  # the header records the runtime config
    lib.config.set(lib.config.CAPTURE_ENABLED, "true")
    lib.config.set(lib.config.CAPTURE_DIR, d)
    obs = _stream(lib, depth, steps=4)
    stream = _decoded_stream(d)
    shutil.rmtree(d)
    custom = sum(int((np.asarray(item[-1][1]) == lib.E.BLOCK_CUSTOM).sum())
                 for kind, item in stream if kind == "chunk" and item[-1] is not None)
    return obs, stream, custom


@pytest.mark.parametrize("depth", [0, 2])
def test_captured_verdicts_carry_block_custom(depth, tmp_path):
    """The journal records the custom blocks the fill gave (BLOCK_CUSTOM in
    its verdict frames), as the JAX journal does: the decoded streams equal."""
    _obs, _stream_, custom = run_lockstep(_captured, depth, str(tmp_path))
    assert custom > 0
