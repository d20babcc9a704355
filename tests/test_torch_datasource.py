"""The port's datasource base and file sources (sentinel_tpu_torch/datasource/
{base,file_source}.py) against the JAX package's, on the CPU.

The cases of tests/test_datasource.py on both packages: the JSON converter
(camelCase fields, empty input), the file source's refresh on a change and
its skip when unmodified, the writable round trip, the writable registry
and the in-memory push, each through the package's own rule managers and
global engine under a ManualClock (tests/torch_transport_env.py). Rules are
compared as dicts, verdicts as pass/block. Plus the push base's bad
payload, and the polling source's start and close (its interval is never
waited on: the first load happens in ``start``)."""

import json
import os
import time

import pytest

from torch_transport_env import pair  # noqa: F401


def test_json_converter_camel_case(pair):
    out = []
    for p in pair.sides:
        conv = p.ds.json_converter(p.st.FlowRule)
        rules = conv('[{"resource": "r", "count": 5, "controlBehavior": 2, "maxQueueingTimeMs": 100}]')
        one = conv('{"resource": "s", "count": 1}')
        out.append(([r.to_dict() for r in rules], [r.to_dict() for r in one], conv(""), conv("[]"), conv("  ")))
    assert out[0] == out[1]
    assert out[1][0][0]["control_behavior"] == 2 and out[1][0][0]["max_queueing_time_ms"] == 100
    assert out[1][2] == out[1][3] == []


def test_json_converter_bad_payload_raises_alike(pair):
    for p in pair.sides:
        with pytest.raises(ValueError):
            p.ds.json_converter(p.st.FlowRule)("{broken")


def test_refresh_on_change(pair, tmp_path):
    got = []
    for p in pair.sides:
        path = tmp_path / f"{p.name}.json"
        path.write_text(json.dumps([{"resource": "fs", "count": 1}]))
        src = p.ds.FileRefreshableDataSource(str(path), p.ds.json_converter(p.st.FlowRule), 999)
        p.st.flow_rule_manager.register_property(src.get_property())
        seq = [src.refresh(), p.st.try_entry("fs") is not None, p.st.try_entry("fs") is None]
        path.write_text(json.dumps([{"resource": "fs", "count": 100}]))
        os.utime(path, (time.time() + 5, time.time() + 5))  # a distinct mtime
        seq.append(src.refresh())
        p.clock.advance(2000)  # a new window
        for _ in range(5):
            e = p.st.try_entry("fs")
            seq.append(e is not None)
            e.exit()
        seq.append([r.to_dict() for r in p.st.flow_rule_manager.get_rules()])
        got.append(seq)
    assert got[0] == got[1]
    assert got[1][:4] == [True, True, True, True] and all(got[1][4:9])


def test_unmodified_skips(pair, tmp_path):
    got = []
    for p in pair.sides:
        path = tmp_path / f"{p.name}.json"
        path.write_text("[]")
        src = p.ds.FileRefreshableDataSource(str(path), p.ds.json_converter(p.st.FlowRule), 999)
        missing = p.ds.FileRefreshableDataSource(str(tmp_path / "none.json"), p.ds.json_converter(p.st.FlowRule), 999)
        got.append((src.refresh(), src.refresh(), missing.refresh(), missing.read_source()))
    assert got[0] == got[1] == (True, False, False, None)


def test_writable_roundtrip(pair, tmp_path):
    got = []
    for p in pair.sides:
        path = tmp_path / p.name / "w.json"
        w = p.ds.FileWritableDataSource(str(path), lambda rules: json.dumps([r.to_dict() for r in rules]))
        w.write([p.st.FlowRule("wr", count=7)])
        r = p.ds.FileRefreshableDataSource(str(path), p.ds.json_converter(p.st.FlowRule), 999)
        r.refresh()
        got.append((path.read_text(), [x.to_dict() for x in r.get_property().value]))
    assert got[0] == got[1]
    assert got[1][1][0]["resource"] == "wr" and got[1][1][0]["count"] == 7


def test_writable_registry(pair, tmp_path):
    got = []
    for p in pair.sides:
        reg = p.ds.WritableDataSourceRegistry
        reg.clear()
        path = tmp_path / f"{p.name}.json"
        w = p.ds.FileWritableDataSource(str(path), lambda v: json.dumps(v))
        reg.register("flow", w)

        class Broken(p.ds.WritableDataSource):
            def write(self, value):
                raise OSError("disk gone")

        reg.register("system", Broken())
        got.append((reg.try_write("flow", [{"resource": "x"}]), json.loads(path.read_text())[0]["resource"],
                    reg.try_write("degrade", []), reg.try_write("system", []), reg.get("flow") is w))
        reg.clear()
        got[-1] += (reg.get("flow"),)
    assert got[0] == got[1] == (True, "x", False, False, True, None)


def test_in_memory_push_updates_manager(pair):
    got = []
    for p in pair.sides:
        src = p.ds.InMemoryDataSource(p.ds.json_converter(p.st.FlowRule))
        p.st.flow_rule_manager.register_property(src.get_property())
        src.write(json.dumps([{"resource": "mem", "count": 2}]))
        got.append((len(p.st.flow_rule_manager.get_rules()), src.read_source(),
                    [p.st.try_entry("mem") is not None for _ in range(3)]))
    assert got[0] == got[1] and got[1][2] == [True, True, False]


def test_push_source_and_polling_start_close(pair, tmp_path):
    got = []
    for p in pair.sides:
        push = p.ds.PushDataSource(p.ds.json_converter(p.st.FlowRule))
        seq = [push.on_update('[{"resource": "p", "count": 3}]'), push.on_update("{bad"), push.on_update(None),
               push.read_source()]
        path = tmp_path / f"{p.name}-poll.json"
        path.write_text(json.dumps([{"resource": "poll", "count": 4}]))
        src = p.ds.FileRefreshableDataSource(str(path), p.ds.json_converter(p.st.FlowRule), 3600)
        src.start()  # the first load, then a daemon poller that never wakes here
        seq.append([r.to_dict() for r in src.get_property().value])
        src.close()
        src._thread.join(timeout=30)
        seq.append(src._thread.is_alive())
        got.append(seq)
    assert got[0] == got[1]
    assert got[1][:4] == [True, False, True, None] and got[1][-1] is False
