"""The port's replay (``python -m sentinel_tpu_torch.runtime.replay``)
against ``tools/replay.py`` on the JAX engine, on the CPU.

The golden corpus (tests/data/capture_corpus/) verifies with zero diffs
at depths 0 and 2, and ``--strict`` gives the JAX tool's report; a
capture the port's engine wrote with the speculative tier on and a
failover fault (rows flagged speculative and degraded) gives the JAX
tool's reports too, strict and not; ``explain`` on an admitted row, a
row blocked by a flow rule and one blocked by a breaker gives the JAX
tool's dict; ``trace_dict`` its events; the command line's modes run.
The engine the replay builds is on the card unless it is asked for the
CPU: without a card the default raises. On the card:
``tests/test_torch_kernels_gpu.py::test_capture_replays_bit_exact_on_card``."""

import importlib.util
import json
import os

import numpy as np
import pytest

from sentinel_tpu.runtime import capture as jcap

from sentinel_tpu_torch.runtime import capture as pcap
from sentinel_tpu_torch.runtime import replay

from torch_lockstep import canon

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tests", "data", "capture_corpus")


def _jax_tool():
    spec = importlib.util.spec_from_file_location("_jax_tools_replay", os.path.join(ROOT, "tools", "replay.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def jax_config():
    """tools/replay.py leaves the captured config set: restore it."""
    from sentinel_tpu.utils.config import config

    with config._lock:
        saved = dict(config._runtime)
    yield
    with config._lock:
        config._runtime.clear()
        config._runtime.update(saved)


def _jax_decoded(directory):
    return jcap.decode_capture(jcap.capture_paths(directory, frozen=True))


@pytest.mark.parametrize("depth", [0, 2])
def test_corpus_verifies_with_zero_diffs(depth):
    report = replay.verify(replay.load_capture(CORPUS), depth=depth, device="cpu")
    assert report["diffs"] == 0, report["samples"]
    assert report["compared"] == report["rows"] > 300
    assert report["no_captured_verdict"] == report["not_replayed"] == report["skipped_flagged"] == 0


@pytest.mark.parametrize("depth", [0, 2])
def test_strict_report_equals_the_jax_tools(depth, jax_config):
    want = _jax_tool().verify(_jax_decoded(CORPUS), depth=depth, strict=True)
    got = replay.verify(replay.load_capture(CORPUS), depth=depth, strict=True, device="cpu")
    assert got == want


def _flagged_capture(directory):
    """A capture of the port's engine with the speculative tier on and a
    failed copy back in mid-stream: speculative and degraded rows."""
    import sentinel_tpu_torch as st
    from sentinel_tpu_torch.runtime.engine import Engine
    from sentinel_tpu_torch.testing.faults import FaultInjector
    from sentinel_tpu_torch.utils.clock import ManualClock
    from sentinel_tpu_torch.utils.config import config

    for k, v in ((config.CAPTURE_ENABLED, "true"), (config.CAPTURE_DIR, directory),
                 (config.SPECULATIVE_ENABLED, "true"), (config.FAILOVER_ENABLED, "true"),
                 (config.FAILOVER_PROBE_FLUSHES, "1")):
        config.set(k, v)
    try:
        clock = ManualClock(1000)
        eng = Engine(clock=clock, device="cpu")
        eng.set_flow_rules([st.FlowRule(f"f{i}", count=5 + i) for i in range(4)])
        inj = FaultInjector().install(eng)
        rng = np.random.default_rng(5)
        for step in range(10):
            now = 1000 + 150 * step
            clock.set_ms(now)
            if step == 4:
                inj.fail_fetch(eng.flush_seq + 1)
            if step == 7:
                eng.failover.try_recover()
            for i in range(4):
                eng.submit_bulk(f"f{i}", int(rng.integers(2, 12)), ts=now)
            for _ in range(3):
                eng.submit_entry(f"f{step % 4}", ts=now)
            eng.flush()
            eng.drain()
        inj.clear()
        eng.close()
    finally:
        config.reset()


def test_flagged_capture_reports_equal_the_jax_tools(tmp_path, jax_config):
    d = str(tmp_path / "cap")
    _flagged_capture(d)
    decoded = pcap.decode_capture(pcap.capture_paths(d, frozen=True))
    flags = np.concatenate([ck.verdicts[3] for ck in decoded["chunks"].values() if ck.verdicts is not None])
    assert (flags & 1).any() and (flags & 2).any(), "speculative and degraded rows"
    tool = _jax_tool()
    for strict in (False, True):
        want = tool.verify(_jax_decoded(d), strict=strict)
        got = replay.verify(replay.load_capture(d), strict=strict, device="cpu")
        assert got == want, strict
        assert got["compared"] > 0
    assert got["skipped_flagged"] == 0 and want["compared"] == want["rows"]


def _corpus_seqs():
    """The first admitted row, the first row blocked by a flow rule and
    the first blocked by a breaker."""
    from sentinel_tpu_torch.core import errors as E

    want = {"admitted": None, "flow": None, "breaker": None}
    for kind, ck in _jax_decoded(CORPUS)["stream"]:
        if kind != "chunk" or ck.verdicts is None:
            continue
        adm, rea = ck.verdicts[0], ck.verdicts[1]
        for i in range(ck.rows):
            key = "admitted" if adm[i] else {E.BLOCK_FLOW: "flow", E.BLOCK_DEGRADE: "breaker"}.get(int(rea[i]))
            if key is not None and want[key] is None:
                want[key] = ck.cap_seq + i
    assert None not in want.values(), want
    return want


@pytest.mark.parametrize("which", ["admitted", "flow", "breaker"])
def test_explain_equals_the_jax_tools(which, jax_config):
    seq = _corpus_seqs()[which]
    want = _jax_tool().explain(_jax_decoded(CORPUS), seq)
    got = replay.explain(replay.load_capture(CORPUS), seq, device="cpu")
    assert canon(got) == canon(want)
    if which != "admitted":
        assert got["replayed"]["deciding_rule"]["resource"] == got["row"]["resource"]
        assert not got["replayed"]["admitted"]


def test_trace_dict_equals_the_jax_tools():
    want = _jax_tool().trace_dict(_jax_decoded(CORPUS))
    got = replay.trace_dict(replay.load_capture(CORPUS))
    assert got == want
    assert len(got["traceEvents"]) > 10


def test_command_line_modes(tmp_path, capsys):
    out = str(tmp_path / "trace.json")
    replay.main(["--dir", CORPUS, "--device", "cpu", "--verify", "--depth", "2", "--bench", "--trace", out])
    text = capsys.readouterr().out
    assert "replay verified:" in text and '"rows_per_s"' in text and '"device": "cpu"' in text
    with open(out, encoding="utf-8") as f:
        assert json.load(f)["traceEvents"]
    seq = _corpus_seqs()["flow"]
    replay.main(["--dir", CORPUS, "--device", "cpu", "--explain", str(seq)])
    assert '"deciding_rule"' in capsys.readouterr().out


def test_the_default_device_is_the_card():
    """No fallback: without a card the replay's default engine raises."""
    import torch

    decoded = replay.load_capture(CORPUS)
    if torch.cuda.is_available():
        report = replay.verify(decoded)
        assert report["diffs"] == 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            replay.verify(decoded)
