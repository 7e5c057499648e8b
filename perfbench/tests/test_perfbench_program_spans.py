"""The port's own tracer (``reinforcement_learning_torch/utils/tracing.py``)
beside the benchmark's probe: a traced run on the CPU at the tests' tiny
size, with the tracer on from the start, is still correct, reports the
per-layer metrics a CPU run can read, and labels the breakdown's idle gaps
with the probe's five spans alone, while the tracer records the program's
spans under the same profiler."""

from conftest import shrink
from perfbench import harness, program
from reinforcement_learning_torch.utils import tracing

SEED = 2 ** 31 + 14


def test_program_spans_leave_the_benchmark_as_it_was():
    tracing.reset()
    tracing.enable()
    try:
        result = harness.run("bench-2v2.train", SEED, 0.0, True, "cpu",
                             shrink=shrink)
        spans = tracing.summary()["spans"]
    finally:
        tracing.disable()
        tracing.reset()
    assert result["correct"], result["checks"]
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    # the CPU has no device trace to read
    want = {m["name"] for m in bench["per_layer"]
            if "bench-2v2.train" in m.get("workloads", ["bench-2v2.train"])
            and m["source"] != "device_trace"}
    assert set(result["metrics"]) == want
    labels = {name for name, _ in result["breakdown"]["idle_gaps"]}
    assert labels <= set(program.SPANS) | {"outside any span"}
    assert {"iter", "iter.collect", "env.physics", "env.post",
            "iter.update"} <= set(spans)
