"""The port's per-resource provenance ledger against the JAX package's:
the ledger alone (notes, columnar notes, the capacity fold, draining by
second, totals) and on lockstep streams (the speculative tier's serves and
drift, the valve's sheds, degraded fills while the device is lost), where
the drained columns must equal the JAX engine's."""

import numpy as np
import pytest

from sentinel_tpu.metrics import provenance as jpv
from sentinel_tpu_torch.metrics import provenance as tpv

from torch_lockstep import run_lockstep


def _ops(led):
    led.note(1500, "a", spec=3, degraded=1)
    led.note(1999, "a", shed=2, over=1)
    led.note(2000, "b", under=4)
    led.note_serves_batch({(2000, "a"): [5, 2], (3000, "c"): [1, 0]})
    led.note_col("b", np.array([999, 1000, 1001, 2500], np.int32), weights=np.array([1, 2, 3, 4]), spec=True,
                 degraded=True)
    led.note_col("z", np.array([], np.int32), shed=True)
    for i in range(12):  # past the capacity of 8: the fold row
        led.note(4000 + i, f"r{i}", shed=1)
    return [led.drain_seconds(3000), led.totals(), led.snapshot(), led.drain_seconds(10_000), led.drain_seconds(10**9)]


def test_ledger_matches_jax():
    assert _ops(tpv.ResourceProvenance(enabled=True, capacity=8)) == _ops(jpv.ResourceProvenance(enabled=True,
                                                                                                  capacity=8))
    assert tpv.OTHER_RESOURCE == jpv.OTHER_RESOURCE


def _prov_stream(lib, spec, chaos, seed=9):
    """Entries and bulk groups on four resources with the speculative tier
    on or off, the valve's bulk bound shedding, and with ``chaos`` a
    fetch fault (failover armed; DEGRADED for a while, then recovered).
    Every second's drained (second, resource, speculative, degraded, shed,
    drift) rows and the totals."""
    st = lib.st
    rng = np.random.default_rng(seed)
    lib.clock.set_ms(1000)
    cfg = dict(SPECULATIVE_ENABLED=str(spec).lower(), SPECULATIVE_FLUSH_BATCH="100000", INGEST_MAX_PENDING_BULK="40")
    if chaos:
        cfg.update(FAILOVER_ENABLED="true", FAILOVER_PROBE_FLUSHES="1", FAILOVER_CHECKPOINT_EVERY="1")
    eng = lib.mk(**cfg)
    inj = lib.FaultInjector().install(eng) if chaos else None
    eng.set_flow_rules([st.FlowRule(r, count=c) for r, c in (("a", 5), ("b", 9), ("c", 2), ("d", 30))])
    rows = []
    for step in range(16):
        t = 1000 + 300 * step
        lib.clock.set_ms(t)
        for _ in range(int(rng.integers(3, 10))):
            eng.entry_sync("abcd"[int(rng.integers(0, 4))])
        eng.submit_bulk("d", 30, ts=np.full(30, t, np.int32) - rng.integers(0, 300, 30).astype(np.int32))
        eng.submit_bulk("d", 30)  # shed: over the bulk bound
        if chaos and step == 4:
            inj.fail_fetch(eng.flush_seq + 1)
        eng.flush()
        eng.drain()
        rows.append(eng.resource_metrics.drain_seconds(t - t % 1000))
    eng.close()
    rows.append(eng.resource_metrics.drain_seconds(10**9))
    return [rows, eng.resource_metrics.totals(), eng.failover.snapshot()["state"] if chaos else None]


@pytest.mark.parametrize("spec,chaos", [(False, False), (True, False), (True, True), (False, True)],
                         ids=["shed", "speculative", "speculative_failover", "failover"])
def test_provenance_columns_match_jax(spec, chaos):
    rows, totals, _ = run_lockstep(_prov_stream, spec, chaos)
    flat = [r for sec in rows for r in sec]
    assert any(r[4] for r in flat)  # sheds
    if spec:
        assert any(r[2] for r in flat)
    if chaos:
        assert any(r[3] for r in flat)
