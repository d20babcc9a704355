"""The port's metric log against the JAX package's: the bucket read
(``metric_array.bucket_windows`` and ``bucket_read``, K17's plain version)
against JAX's ``bucket_windows`` and the timer's filter, the line format,
the writer's rolled files and ``.idx`` indexes, ``MetricSearcher``, and the
metric timer on a lockstep stream of 65 s (the minute window wraps) with
the provenance columns, the block log and the metric extensions."""

import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentinel_tpu.metrics import metric_array as jma
from sentinel_tpu.metrics import metric_log as jml
from sentinel_tpu_torch.metrics import metric_array as tma
from sentinel_tpu_torch.metrics import metric_log as tml
from sentinel_tpu_torch.metrics.nodes import MINUTE_CFG

from torch_lockstep import run_lockstep

CPU = torch.device("cpu")


def _window(case, n_rows, now, seed=0):
    """A minute window (counts, min_rt, window_start) for the read: each
    bucket holds one of its own seconds of the last 70 s ("wrapped": the
    window wrapped, so the oldest seconds' buckets are stale or rolled),
    some starts of another second on the bucket, a start exactly one
    interval before ``now`` ("edge"), empty starts, half the cells zero."""
    rng = np.random.default_rng(seed)
    nb, wlen = MINUTE_CFG.sample_count, MINUTE_CFG.window_len_ms
    upto = now - now % wlen
    ws = np.full((n_rows, nb), MINUTE_CFG.empty_ws, np.int64)
    sec = upto - wlen * rng.integers(1, 71, (n_rows, nb))
    ws[np.arange(n_rows)[:, None], (sec // wlen) % nb] = sec
    if case in ("wrapped", "edge"):
        other = rng.random((n_rows, nb)) < 0.15
        ws = np.where(other, ws + nb * wlen * rng.choice([-1, 1], (n_rows, nb)), ws)
    if case == "edge":
        ws[:, (upto // wlen - 60) % nb] = upto - MINUTE_CFG.interval_ms  # now - ws > interval once now > upto
        ws[: n_rows // 2, (now // wlen) % nb] = now - MINUTE_CFG.interval_ms  # now - ws == interval exactly
    counts = rng.integers(0, 40, (n_rows, nb, 6)).astype(np.int32)
    counts[rng.random((n_rows, nb)) < 0.5] = 0
    min_rt = np.full((n_rows, nb), MINUTE_CFG.max_rt, np.int32)
    return counts, min_rt, ws.astype(np.int32)


def _jax_records(arrs, rows, begin, upto, now):
    """What the JAX timer keeps of ``bucket_windows`` (metric_log.py:377-403)."""
    state = jma.MetricArrayState(*(jnp.asarray(a) for a in arrs))
    ws, counts, valid = (np.asarray(x) for x in jma.bucket_windows(MINUTE_CFG, state, np.int32(now)))
    out = []
    for i, row in enumerate(rows):
        for sec in range(begin, upto, 1000):
            b = (sec // 1000) % MINUTE_CFG.sample_count
            if not valid[row, b] or ws[row, b] != sec:
                continue
            c = counts[row, b]
            if c.any():
                out.append([i, sec, *c.tolist()])
    return out


@pytest.mark.parametrize("case", ["random", "wrapped", "edge"])
@pytest.mark.parametrize("seconds", [1, 59, 60])
@pytest.mark.parametrize("now_off", [0, 431, 999])
def test_bucket_read_matches_jax(case, seconds, now_off):
    """bucket_read's plain version (what K17 computes) and bucket_windows
    against JAX's bucket_windows plus the timer's three tests, exactly:
    valid at ``now`` (strict age, ``now - ws == interval`` still counts),
    the bucket's start is the asked second, a nonzero count."""
    now = 3_600_000 + now_off
    upto = now - now % 1000
    arrs = _window(case, 48, now, seed=seconds + now_off)
    rows = np.random.default_rng(1).integers(0, 48, 40).astype(np.int32)
    begin = upto - 1000 * seconds
    state = tma.state_from_numpy(arrs, CPU)
    got = tma.bucket_read(MINUTE_CFG, state, torch.from_numpy(rows), begin, upto, now)
    assert got.dtype == torch.int32 and got.shape[1] == tma.BUCKET_RECORD
    assert got.tolist() == _jax_records(arrs, rows, begin, upto, now)
    jws, jcounts, jvalid = jma.bucket_windows(
        MINUTE_CFG, jma.MetricArrayState(*(jnp.asarray(a) for a in arrs)), np.int32(now))
    tws, tcounts, tvalid = tma.bucket_windows(MINUTE_CFG, state, now)
    for j, t in ((jws, tws), (jcounts, tcounts), (jvalid, tvalid)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_bucket_read_empty_and_wrapping_now():
    """No asked rows, no seconds, and ``now`` near 2^31 - 1 (the age wraps
    in int32 for the empty starts, as JAX's does)."""
    now = 2**31 - 1
    upto = now - now % 1000
    arrs = _window("edge", 16, now, seed=5)
    state = tma.state_from_numpy(arrs, CPU)
    rows = np.arange(16, dtype=np.int32)
    assert tma.bucket_read(MINUTE_CFG, state, torch.from_numpy(rows[:0]), upto - 5000, upto, now).shape == (0, 8)
    assert tma.bucket_read(MINUTE_CFG, state, torch.from_numpy(rows), upto, upto, now).shape == (0, 8)
    got = tma.bucket_read(MINUTE_CFG, state, torch.from_numpy(rows), upto - 60_000, upto, now)
    assert got.tolist() == _jax_records(arrs, rows, upto - 60_000, upto, now)


@pytest.mark.parametrize("line", [
    "1700000000000|2023-11-14 22:13:20|res|5|1|4|0|2.5|0|0|0",
    "1700000000000|2023-11-14 22:13:20|r|5|1|4|0|2.5|0|0|0|2|3|1|2|-4",
    "1700000000000|x|r|5|1|4|0|2.5|0|0|0|2|3|x|2|-4",
    "1700000000000|x|r|5|1|4|0|2.5|0|0|0|9|3|1|2|-4|extra",
    "garbage|line",
])
def test_line_format_matches_jax(line):
    """MetricNodeLine's v1/v2 parse (a malformed tail degrades to the seed
    view) and its render equal the JAX package's."""
    j, t = jml.MetricNodeLine.from_line(line), tml.MetricNodeLine.from_line(line)
    assert (j is None) == (t is None)
    if j is not None:
        assert vars(j) == vars(t)
        assert j.to_line() == t.to_line()


def _line_of(pkg, ts, qps):
    return pkg.MetricNodeLine(timestamp=ts, resource=f"res{qps % 3}", pass_qps=qps, block_qps=1, success_qps=qps,
                              rt=2.25 * qps, speculative_qps=qps % 2, drift=-qps)


def test_writer_files_and_searcher_match_jax():
    """The writer's rolled files and ``.idx`` indexes, byte for byte, and
    MetricSearcher's reads (seeking through the index, across the roll)."""
    dirs = {}
    for name, pkg in (("jax", jml), ("port", tml)):
        d = tempfile.mkdtemp(prefix=f"ml-{name}-")
        w = pkg.MetricWriter(base_dir=d, app_name="app", single_file_size=700, total_file_count=3)
        for b in range(12):
            batch = [_line_of(pkg, (b * 2 + i) * 1000, b + i) for i in range(3)]
            w.write(batch[-1].timestamp, batch)
        dirs[name] = d
    jnames, tnames = sorted(os.listdir(dirs["jax"])), sorted(os.listdir(dirs["port"]))
    assert jnames == tnames and len(jnames) == 6
    for n in jnames:
        with open(os.path.join(dirs["jax"], n), "rb") as a, open(os.path.join(dirs["port"], n), "rb") as b:
            assert a.read() == b.read(), n
    for begin, end, res in ((0, 2**61, None), (9000, 14000, None), (15000, 2**61, "res1"), (10**9, 2**61, None)):
        j = jml.MetricSearcher(base_dir=dirs["jax"], app_name="app").find(begin, end, res)
        t = tml.MetricSearcher(base_dir=dirs["port"], app_name="app").find(begin, end, res)
        assert [vars(x) for x in j] == [vars(x) for x in t]
    for path in sorted(os.listdir(dirs["port"])):
        if not path.endswith(".idx"):
            p = os.path.join(dirs["port"], path)
            assert tml.MetricSearcher._start_offset(p, 20_000) == jml.MetricSearcher._start_offset(
                os.path.join(dirs["jax"], path), 20_000)


class _Recorder:
    """A metric extension that records every call (the BlockError as its
    class name)."""

    def __init__(self, base):
        self.calls = []

        class Ext(base):
            def add_pass(s, resource, n, *args):
                self.calls.append(("pass", resource, n, args))

            def add_block(s, resource, n, origin, block_error, *args):
                self.calls.append(("block", resource, n, origin, type(block_error).__name__, args))

            def add_success(s, resource, n, *args):
                self.calls.append(("success", resource, n))

            def add_exception(s, resource, n, throwable):
                self.calls.append(("exception", resource, n))

            def add_rt(s, resource, rt_ms, *args):
                self.calls.append(("rt", resource, rt_ms))

            def increase_thread_num(s, resource, *args):
                self.calls.append(("inc", resource))

            def decrease_thread_num(s, resource, *args):
                self.calls.append(("dec", resource))

        self.ext = Ext()


def _metric_stream(lib, telemetry, spec, seconds=65, seed=3):
    """65 s of traffic on a ManualClock, a metric-timer pull each second:
    flow rules on 8 resources (one bulk-heavy, one with a breaker, one with
    a param rule), a resource over the ingest valve's bulk bound (sheds),
    singles with args, exits with RT and errors. Returns the lines of every
    pull, the files the searcher finds, the raw files, the block log and
    the extension calls."""
    st, C = lib.st, lib.C
    pkg = "sentinel_tpu_torch" if lib.name == "port" else "sentinel_tpu"
    ml = __import__(f"{pkg}.metrics.metric_log", fromlist=["x"])
    ext_mod = __import__(f"{pkg}.metrics.extension", fromlist=["x"])
    rng = np.random.default_rng(seed)
    d = tempfile.mkdtemp(prefix=f"mstream-{lib.name}-")
    lib.config.set(lib.config.LOG_DIR, d)
    rec = _Recorder(ext_mod.MetricExtension)
    ext_mod.MetricExtensionProvider.clear()
    ext_mod.MetricExtensionProvider.register(rec.ext)
    lib.clock.set_ms(500)
    cfg = dict(TELEMETRY_ENABLED=str(telemetry).lower(), SPECULATIVE_ENABLED=str(spec).lower(),
               SPECULATIVE_FLUSH_BATCH="100000", INGEST_MAX_PENDING_BULK="40", TRACE_SAMPLE_RATE="0")
    eng = lib.mk(**cfg)
    try:
        res = [f"r{i}" for i in range(8)]
        eng.set_flow_rules([st.FlowRule(r, count=int(c)) for r, c in zip(res, (5, 9, 3, 20, 7, 2, 50, 4))])
        eng.set_degrade_rules([st.DegradeRule("r2", grade=C.DEGRADE_GRADE_EXCEPTION_COUNT, count=2, time_window=2,
                                              min_request_amount=1)])
        eng.set_param_rules({"r4": [st.ParamFlowRule("r4", param_idx=0, count=2)]})
        timer = ml.MetricTimer(eng, writer=ml.MetricWriter(base_dir=d, app_name="app", single_file_size=4000,
                                                           total_file_count=4))
        pulls = []
        held = []
        for s in range(seconds):
            base = 500 + 1000 * s
            for op in held:
                eng.submit_exit(op.rows, rt=int(rng.integers(1, 80)), count=1, err=int(rng.random() < 0.3),
                                resource=op.resource)
            ops = []
            for _ in range(int(rng.integers(5, 25))):
                r = res[int(rng.integers(0, 8))]
                ops.append(eng.submit_entry(r, ts=base + int(rng.integers(0, 400)),
                                            args=(f"v{int(rng.integers(0, 3))}",) if r == "r4" else ()))
            eng.submit_bulk("r6", 30, ts=base + 100)
            eng.submit_bulk("r6", 30, ts=base + 200)  # over the valve's bulk bound: shed whole
            eng.submit_bulk("r1", int(rng.integers(1, 20)), ts=base + 300)
            eng.flush()
            eng.drain()
            held = [op for op in ops if op is not None and op.verdict.admitted]
            lib.clock.set_ms(base + 1000)
            lines = timer.run_once()
            pulls.append([_line_obs(ln) for ln in lines])
        eng.block_log.flush()
        found = [_line_obs(ln) for ln in ml.MetricSearcher(base_dir=d, app_name="app").find(0, 2**62)]
        files = {}
        for n in sorted(os.listdir(d)):
            if n.startswith("app-metrics.log"):
                with open(os.path.join(d, n)) as f:
                    files[n] = [_mask_engine_rt(x) for x in f.read().splitlines()]
        blocks = eng.block_log.read_entries()
        return [pulls, found, files if not telemetry else sorted(files), blocks, rec.calls,
                eng.resource_metrics.totals()]
    finally:
        ext_mod.MetricExtensionProvider.clear()


def _line_obs(ln):
    """A line's fields; the ``__engine__`` line's RT is the flushes' host
    time, which no two runs share."""
    v = dict(vars(ln))
    if v["resource"] == "__engine__":
        v["rt"] = None
    return v


def _mask_engine_rt(text):
    parts = text.split("|")
    if len(parts) > 7 and parts[2] == "__engine__":
        parts[7] = "*"
    return "|".join(parts)


@pytest.mark.parametrize("telemetry,spec", [(False, False), (True, False), (False, True)],
                         ids=["device", "telemetry", "speculative"])
def test_metric_timer_stream_matches_jax(telemetry, spec):
    """The metric timer on a lockstep stream of 65 s (the minute window
    wraps): every pull's lines, the lines the searcher finds, the rolled
    files and their indexes (telemetry off: byte for byte), the block log,
    the extension calls and the provenance totals equal the JAX engine's;
    with telemetry the ``__engine__`` lines too, but their RT."""
    obs = run_lockstep(_metric_stream, telemetry, spec)
    pulls = obs[0]
    assert len(pulls) == 65 and sum(len(p) for p in pulls) > 200
    assert any(p and any(ln["shed_qps"] for ln in p) for p in pulls)
    if spec:
        assert any(ln["speculative_qps"] for p in pulls for ln in p)


def test_metric_timer_reads_through_bucket_read(monkeypatch):
    """The timer reads the minute window through ``bucket_read`` (K17 on the
    card) and nothing else; a failure of the read reaches run_once's
    caller, and no line is written for that pull."""
    from sentinel_tpu_torch.models.rules import FlowRule
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.utils.clock import ManualClock

    clock = ManualClock(1000)
    eng = Engine(clock=clock, device="cpu")
    eng.set_flow_rules([FlowRule("r", count=5)])
    eng.submit_bulk("r", 10)
    eng.flush()
    clock.set_ms(3500)
    d = tempfile.mkdtemp(prefix="mread-")
    timer = tml.MetricTimer(eng, writer=tml.MetricWriter(base_dir=d, app_name="t"))
    calls = []
    real = tma.bucket_read

    def failing(*args):
        calls.append(args)
        raise RuntimeError("bucket_read: CUDA error 700")

    monkeypatch.setattr(tma, "bucket_windows", lambda *a: pytest.fail("the whole window was read"))
    monkeypatch.setattr(tma, "bucket_read", failing)
    with pytest.raises(RuntimeError, match="bucket_read"):
        timer.run_once()
    assert len(calls) == 1 and not os.listdir(d)
    monkeypatch.setattr(tma, "bucket_read", real)
    lines = timer.run_once()
    assert [(ln.resource, ln.pass_qps, ln.block_qps) for ln in lines if ln.resource == "r"] == [("r", 5, 5)]
