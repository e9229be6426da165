"""ark_tpu_torch.utils.profiling against ark_tpu.utils.profiling, on the CPU.

`StageRecord` and `StageTimer` are the JAX package's: the same records,
dicts, printed lines and JSON log lines for the same stages (the seconds
aside, which the clock gives). `trace` writes a Chrome trace that holds
the block's torch ops; asked for a card that is absent it raises. The
card's own trace (CUDA kernel events) is a card test
(tests/test_torch_cuda.py).
"""

import json
import os

import pytest
import torch

from ark_tpu.utils import profiling as JP
from ark_tpu_torch.utils import profiling as TP

torch.set_num_threads(1)


@pytest.mark.parametrize("seconds,items", [(2.0, 10), (0.0, 5), (1.5, None)])
def test_stage_record_matches_jax(seconds, items):
    got = TP.StageRecord("blur", seconds, items, "pixels")
    want = JP.StageRecord("blur", seconds, items, "pixels")
    assert got.throughput == want.throughput
    assert got.to_dict() == want.to_dict()


def test_stage_timer_logs_the_same_lines(tmp_path, capsys, monkeypatch):
    """The same stages under a stepped clock: equal records, reports,
    printed lines and log lines."""
    out = {}
    for name, mod in (("jax", JP), ("port", TP)):
        ticks = iter([10.0, 12.5, 20.0, 20.0])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(ticks))
        log = tmp_path / f"{name}.jsonl"
        timer = mod.StageTimer(log_path=str(log))
        with timer.stage("blur+norm", items=5e6, unit="pixels"):
            pass
        with pytest.raises(ValueError):
            with timer.stage("empty"):
                raise ValueError("the stage's own error passes through")
        out[name] = (timer.report(), timer.total_seconds, log.read_text(),
                     capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert out["port"][1] == 2.5
    assert [json.loads(line)["stage"] for line in out["port"][2].splitlines()] == \
        ["blur+norm", "empty"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with TP.trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    names = {e.name for e in prof.events()}
    assert "aten::matmul" in names
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


def test_trace_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with TP.trace(str(tmp_path)):
            pass
    assert os.listdir(tmp_path) == []
