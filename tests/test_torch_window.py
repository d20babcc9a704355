"""The port's batch window (sentinel_tpu_torch/runtime/window.py) and its
API (``api.entry_windowed``, ``entry_windowed_async``) against the JAX
package's, on the CPU.

The cases of tests/test_ingest_window.py that the port has run here on
both engines in lockstep (tests/torch_lockstep.py): the spine's verdicts
against the JAX engine's and against each package's sequential
``entry_sync`` path, at depth 0 and 2, with and without the speculative
tier; the valve's shed at join (counting the window's queued requests),
a whole-window shed at flush, exits never riding the valve, a cancelled
awaiter releasing its admitted slot, "window off is cold", close serving
the final window, and both windowed entry points. Verdicts, counters and
the state tensors must be identical. Where requests join from threads or
tasks, their order into the window is not deterministic, so those cases
compare the multiset of verdicts (the per-index contract is the spine's).

Left out, each with the ROADMAP Queue 1 item it waits for:
``TestAdapterParity`` and ``test_gateway_entry_rides_the_window`` (the
adapters, item 11). The window's per-request trace records are held in
tests/test_torch_admission_trace.py."""

import asyncio
import contextlib
import sys
import threading

import pytest

from torch_lockstep import run_lockstep, verdict


def _win_mod(eng):
    return sys.modules[type(eng.ingest_window).__module__]


def _reset(lib, depth=0, window_ms="50", batch_max="64", **cfg):
    """``api.reset`` on a windowed configuration (window_ms "0" is off)."""
    lib.config.set(lib.config.INGEST_BATCH_WINDOW_MS, window_ms)
    lib.config.set(lib.config.INGEST_BATCH_MAX, batch_max)
    lib.config.set(lib.config.PIPELINE_DEPTH, str(depth))
    for key, value in cfg.items():
        lib.config.set(getattr(lib.config, key), value)
    return lib.api.reset(clock=lib.clock, **lib.device_kw)


def _load_rules(lib):
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("win-res", count=3)])
    lib.st.param_flow_rule_manager.load_rules([lib.st.ParamFlowRule("win-param", param_idx=0, count=2)])


def _drive_spine(eng, reqs):
    w = eng.ingest_window
    for r in reqs:
        w.join(r)
    for r in reqs:
        assert r.event.wait(30)
        assert r.error is None, r.error
        assert r.verdict is not None
    return reqs


def _settle(eng):
    eng.flush()
    eng.drain()


# --- TestSpineParity ---------------------------------------------------------


def _spine(lib, depth, spec):
    seq = [("win-res", ()) for _ in range(6)] + [("win-param", (f"ip{i % 3}",)) for i in range(6)]
    cfg = {"SPECULATIVE_ENABLED": "true" if spec else "false"}
    eng = _reset(lib, depth=depth, window_ms="0", **cfg)
    _load_rules(lib)
    lib.clock.set_ms(1000)
    oracle = []
    for res, args in seq:
        _, v = eng.entry_sync(res, entry_type=lib.C.EntryType.IN, args=args)
        oracle.append(verdict(v))
    _settle(eng)
    seq_state = lib.states(eng)
    eng = _reset(lib, depth=depth, batch_max=str(len(seq)), **cfg)
    _load_rules(lib)
    lib.clock.set_ms(1000)
    mod = _win_mod(eng)
    reqs = [mod.WindowRequest(res, lib.C.CONTEXT_DEFAULT_NAME, "", 1, lib.C.EntryType.IN, args, eng.clock.now_ms(),
                              None) for res, args in seq]
    _drive_spine(eng, reqs)
    got = [verdict(r.verdict) for r in reqs]
    # The window's verdicts are the sequential path's, decision for decision.
    assert [g[:3] for g in got] == [o[:3] for o in oracle]
    assert all(g[5] == spec for g in got[:6])
    snap = eng.ingest_window.snapshot()
    assert snap["reqs"] == len(seq) and snap["flushes"] == 1
    eng.close()
    _settle(eng)
    tele = eng.telemetry.counters_snapshot()
    return got, oracle, seq_state, lib.states(eng), (tele["ingest_window_reqs"], tele["ingest_window_flushes"])


@pytest.mark.parametrize("spec", [False, True], ids=["device", "speculative"])
@pytest.mark.parametrize("depth", [0, 2])
def test_spine_parity(depth, spec):
    run_lockstep(_spine, depth, spec)


# --- TestShedBeforeAssembly --------------------------------------------------


def _shed_at_join(lib):
    eng = _reset(lib, window_ms="5000", batch_max="64", INGEST_MAX_PENDING_BULK="4")
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("s", count=1e9)])
    lib.clock.set_ms(1000)
    w = eng.ingest_window
    done = []

    def call():
        try:
            done.append(lib.api.entry_windowed("s", entry_type=lib.C.EntryType.IN, detached=True))
        except lib.E.IngestShedError:
            done.append("shed")

    ths = [threading.Thread(target=call) for _ in range(4)]
    for t in ths:
        t.start()
    for _ in range(600):
        if w.pending_n >= 4:
            break
        threading.Event().wait(0.05)
    assert w.pending_n == 4
    try:
        lib.api.entry_windowed("s", entry_type=lib.C.EntryType.IN, detached=True)
        shed = None
    except lib.E.IngestShedError as exc:
        shed = type(exc).__name__
    assert shed == "IngestShedError"
    assert w.pending_n == 4, "a shed request must never join"
    assert eng.ingest.counters["shed_rows"] == 1
    g = eng.submit_bulk("s", 2)  # the queued window contents bound a direct bulk submit too
    assert (g.reason == lib.E.BLOCK_SHED).all()
    with w._cond:
        w2 = w._open
        if w2 is not None and len(w2.reqs) >= 4:
            w._open = None
            w._ready.append(w2)
            w._cond.notify_all()
    for t in ths:
        t.join(30)
    entries = [d for d in done if d != "shed"]
    assert len(entries) == 4
    for e in entries:
        e.exit()
    eng.close()
    _settle(eng)
    assert eng.cluster_node_stats("s")["cur_thread_num"] == 0
    return sorted(verdict(e.verdict) for e in entries), g.reason, eng.ingest.snapshot()["counters"], lib.states(eng)


def test_shed_at_join_counts_window_contents():
    run_lockstep(_shed_at_join)


def _whole_window_shed(lib):
    eng = _reset(lib, window_ms="5000", batch_max="64", INGEST_MAX_PENDING_BULK="6")
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("ws", count=1e9)])
    lib.clock.set_ms(1000)
    w = eng.ingest_window
    mod = _win_mod(eng)
    win = mod._OpenWindow(deadline=0.0)
    for _ in range(4):
        r = mod.WindowRequest("ws", lib.C.CONTEXT_DEFAULT_NAME, "", 1, lib.C.EntryType.IN, (), eng.clock.now_ms(),
                              None)
        r.event = win.event
        win.reqs.append(r)
        w.pending_n += 1
    w.pending_n -= 4  # the race: the window's contents not yet counted
    g0 = eng.submit_bulk("ws", 4)
    assert g0 is not None
    w.pending_n += 4
    settled = w._dispatch_window(win)
    w._fan_out_window(win, settled)
    out = [verdict(r.verdict) for r in win.reqs]
    assert all(v[1] == lib.E.BLOCK_SHED and not v[0] for v in out)
    assert eng.ingest.counters["shed_rows"] == 4
    eng.close()
    _settle(eng)
    return out, g0.admitted, eng.ingest.snapshot()["counters"], eng.telemetry.counters_snapshot()["ingest_shed"]


def test_whole_window_shed():
    run_lockstep(_whole_window_shed)


def _exits_never_ride_the_valve(lib):
    eng = _reset(lib, window_ms="20", batch_max="2", INGEST_MAX_PENDING_BULK="2", FLUSH_INTERVAL_MS="0")
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("x", grade=lib.C.FLOW_GRADE_THREAD, count=10)])
    lib.clock.set_ms(1000)
    entries = []

    def call():
        try:
            entries.append(lib.api.entry_windowed("x", entry_type=lib.C.EntryType.IN, detached=True))
        except lib.E.BlockError:
            pass

    ths = [threading.Thread(target=call) for _ in range(2)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(30)
    assert len(entries) == 2
    eng.submit_bulk("other", 2)
    for e in entries:
        e.exit()
    _settle(eng)
    eng.ingest_window.close()
    _settle(eng)
    assert eng.cluster_node_stats("x")["cur_thread_num"] == 0
    return sorted(verdict(e.verdict) for e in entries), lib.states(eng)


def test_exits_never_ride_the_valve():
    run_lockstep(_exits_never_ride_the_valve)


# --- TestCancellation --------------------------------------------------------


def _cancelled_awaiter(lib):
    eng = _reset(lib, window_ms="30", batch_max="4")
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("c", grade=lib.C.FLOW_GRADE_THREAD, count=10)])
    lib.clock.set_ms(1000)

    async def main():
        tasks = [asyncio.ensure_future(lib.api.entry_windowed_async("c", entry_type=lib.C.EntryType.IN))
                 for _ in range(4)]
        await asyncio.sleep(0)
        tasks[0].cancel()
        tasks[1].cancel()
        done = []
        for t in tasks:
            try:
                done.append(await t)
            except asyncio.CancelledError:
                pass
        return done

    entries = asyncio.run(main())
    assert len(entries) == 2
    for e in entries:
        e.exit()
    _settle(eng)
    assert eng.cluster_node_stats("c")["cur_thread_num"] == 0
    eng.ingest_window.close()
    _settle(eng)
    return sorted(verdict(e.verdict) for e in entries), lib.states(eng)


def test_cancelled_awaiter_releases_its_admitted_slot():
    run_lockstep(_cancelled_awaiter)


@pytest.mark.parametrize("release_fails", [False, True], ids=["released", "release_raises"])
def test_fan_out_releases_abandoned_before_wake(release_fails):
    """The port's fan-out queues every abandoned request's auto-exit before
    it wakes the waiters, so a survivor that exits and flushes at once finds
    the auto-exits in the exit buffer; a release that raises still wakes
    them. (The JAX window wakes first: a deliberate difference.)"""
    from sentinel_tpu_torch.core import api
    from sentinel_tpu_torch.models import constants as C
    from sentinel_tpu_torch.runtime import window as wmod
    from sentinel_tpu_torch.utils.clock import ManualClock
    from sentinel_tpu_torch.utils.config import config

    config.set(config.INGEST_BATCH_WINDOW_MS, "5000")
    try:
        eng = api.reset(clock=ManualClock(1000), device="cpu")
        w = eng.ingest_window
        win = wmod._OpenWindow(deadline=0.0)
        for i in range(4):
            r = wmod.WindowRequest("o", C.CONTEXT_DEFAULT_NAME, "", 1, C.EntryType.IN, (), 1000, None)
            r.event = win.event
            r.abandoned = i % 2 == 0
            win.reqs.append(r)
        order = []

        def release(r):
            order.append(("release", win.reqs.index(r)))
            if release_fails:
                raise RuntimeError("release failed")

        def wake(wf):
            order.append(("wake", wf is win))

        w.release_abandoned = release
        w._wake = wake
        with pytest.raises(RuntimeError) if release_fails else contextlib.nullcontext():
            w._fan_out_window(win, [])
        if release_fails:
            assert order == [("release", 0), ("wake", True)]
        else:
            assert order == [("release", 0), ("release", 2), ("wake", True)]
        del w.release_abandoned, w._wake
        eng.close()
    finally:
        config.reset()
        api.reset(device="cpu")


# --- TestWindowLifecycle -----------------------------------------------------


def _window_off_is_cold(lib):
    eng = lib.api.reset(clock=lib.clock, **lib.device_kw)
    assert not eng.ingest_window.armed and eng.ingest_window._thread is None
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("cold", count=1)])
    lib.clock.set_ms(1000)
    e = lib.api.entry_windowed("cold", entry_type=lib.C.EntryType.IN, detached=True)
    e.exit()
    try:
        lib.api.entry_windowed("cold", entry_type=lib.C.EntryType.IN, detached=True)
        blocked = None
    except lib.E.FlowBlockError as exc:
        blocked = type(exc).__name__
    assert blocked == "FlowBlockError"
    assert eng.ingest_window._thread is None
    _settle(eng)
    return verdict(e.verdict), blocked, eng.ingest_window.snapshot(), lib.states(eng)


def test_window_off_is_cold():
    run_lockstep(_window_off_is_cold)


def _close_serves_final_window(lib):
    eng = _reset(lib, window_ms="5000", batch_max="64")
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("fin", count=1e9)])
    lib.clock.set_ms(1000)
    got = []
    t = threading.Thread(target=lambda: got.append(
        lib.api.entry_windowed("fin", entry_type=lib.C.EntryType.IN, detached=True)))
    t.start()
    for _ in range(3000):
        if eng.ingest_window.pending_n >= 1:
            break
        threading.Event().wait(0.01)
    eng.ingest_window.close()
    t.join(30)
    assert len(got) == 1 and got[0].verdict.admitted
    got[0].exit()
    _settle(eng)
    assert eng.cluster_node_stats("fin")["cur_thread_num"] == 0
    return verdict(got[0].verdict), lib.states(eng)


def test_close_serves_the_final_window():
    run_lockstep(_close_serves_final_window)


# --- the windowed entry points -----------------------------------------------


def _entry_windowed(lib, depth):
    """Six threads through ``entry_windowed`` on a 3-per-second rule: three
    Entries, three FlowBlockErrors, the exits batched through the window."""
    eng = _reset(lib, depth=depth, window_ms="20", batch_max="6")
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("w", count=3)])
    lib.clock.set_ms(1000)
    out, lock = [], threading.Lock()

    def call():
        try:
            e = lib.api.entry_windowed("w")
            res = ("pass", verdict(e.verdict), e._exit_sink is not None)
            e.exit()
        except lib.E.FlowBlockError:
            res = ("block", None, None)
        with lock:
            out.append(res)

    ths = [threading.Thread(target=call) for _ in range(6)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(30)
    eng.close()
    _settle(eng)
    assert sorted(r[0] for r in out) == ["block"] * 3 + ["pass"] * 3
    assert all(r[2] for r in out if r[0] == "pass")  # exits ride the window's columnar batch
    stats = eng.cluster_node_stats("w")
    assert stats["cur_thread_num"] == 0 and stats["total_success_minute"] == 3
    return sorted(out, key=repr), lib.states(eng)


@pytest.mark.parametrize("depth", [0, 2])
def test_entry_windowed(depth):
    run_lockstep(_entry_windowed, depth)


def _entry_windowed_async(lib):
    eng = _reset(lib, window_ms="20", batch_max="6")
    lib.st.flow_rule_manager.load_rules([lib.st.FlowRule("wa", count=3)])
    lib.clock.set_ms(1000)

    async def call():
        try:
            e = await lib.api.entry_windowed_async("wa")
            return ("pass", verdict(e.verdict), e)
        except lib.E.FlowBlockError:
            return ("block", None, None)

    async def main():
        return await asyncio.gather(*[call() for _ in range(6)])

    out = asyncio.run(main())
    for r in out:
        if r[2] is not None:
            r[2].exit()
    eng.close()
    _settle(eng)
    assert sorted(r[0] for r in out) == ["block"] * 3 + ["pass"] * 3
    assert eng.cluster_node_stats("wa")["cur_thread_num"] == 0
    return sorted((r[0], r[1]) for r in out), eng.ingest_window.snapshot()["reqs"], lib.states(eng)


def test_entry_windowed_async():
    run_lockstep(_entry_windowed_async)
