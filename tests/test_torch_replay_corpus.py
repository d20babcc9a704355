"""The golden capture corpus (tests/data/capture_corpus/, written by
tests/data/gen_capture_corpus.py) replayed through the port's engine on
the CPU, as the port's gate: flow QPS and THREAD rules, a breaker, a
hot-parameter rule with args on singles and bulk groups, a mid-stream
reload, exits, a rollover and freezes. The corpus is decoded with the
port's capture reader (which reads it as the JAX package's reader does:
tests/test_torch_capture.py) and fed, rule timeline and chunks, through
the port's replay (``sentinel_tpu_torch.runtime.replay``) to a fresh port
``Engine(device="cpu")`` at pipeline depth 0 on a ManualClock, as
``tools/replay.py`` feeds the JAX engine; every captured verdict (admitted,
reason, wait_ms) must come back identical, with every row compared.
Health and freeze records are annotations there and here."""

import os

from sentinel_tpu.runtime import capture as cap_mod

from sentinel_tpu_torch.runtime import capture as pcap

CORPUS = os.path.join(os.path.dirname(__file__), "data", "capture_corpus")


def _decoded():
    paths = pcap.capture_paths(CORPUS, frozen=True)
    assert paths, "corpus missing: run tests/data/gen_capture_corpus.py"
    return pcap.decode_capture(paths)


def test_corpus_replays_on_the_port_with_zero_diffs():
    from sentinel_tpu.ipc import frames

    from sentinel_tpu_torch.runtime import replay
    from sentinel_tpu_torch.utils.config import config

    decoded = _decoded()
    skip_bits = frames.F_DEGRADED | frames.F_SPECULATIVE | cap_mod.F_VERDICT_MISSING
    assert replay.SKIP_BITS == skip_bits
    before = config.runtime_snapshot()
    res = replay.replay(decoded, depth=0, device="cpu")
    assert config.runtime_snapshot() == before, "the replay restores the caller's config"
    eng = res["engine"]
    assert eng.device.type == "cpu" and eng.capture is None and eng.pipeline_depth == 0
    assert res["skipped_rules"] == 0
    rows = compared = 0
    diffs = []
    try:
        for ck, entry_ops, bulk_ops in res["chunks"]:
            got = replay._replayed_arrays(ck, entry_ops, bulk_ops)
            rows += ck.rows
            if ck.rows == 0:
                continue  # an exits-only chunk: nothing to compare
            assert ck.verdicts is not None, "every chunk with entries carries its verdicts"
            c_adm, c_rea, c_wait, c_flags = ck.verdicts
            for i in range(ck.rows):
                assert not int(c_flags[i]) & skip_bits, "no captured row is flagged"
                assert got[3][i], "every captured row was replayed"
                compared += 1
                want = (int(c_adm[i]), int(c_rea[i]), int(c_wait[i]))
                if want != tuple(int(x[i]) for x in got[:3]):
                    diffs.append((ck.cap_seq + i, want, tuple(int(x[i]) for x in got[:3])))
    finally:
        eng.close()
    assert not diffs, diffs[:20]
    assert compared == rows > 300
    kinds = {kind for kind, _item in decoded["stream"]}
    assert {"chunk", "rules", "health", "freeze"} <= kinds
    # What the rows exercise: blocks by the flow, param and breaker stages.
    reasons = {int(r) for _k, ck in decoded["stream"] if _k == "chunk" and ck.rows for r in ck.verdicts[1]}
    assert {0, 1, 2, 5} <= reasons, reasons
