"""A CPU smoke of the port's weak-scaling harness
(``reinforcement_learning_torch/tools/bench_scaling.py``): 1 and 2 gloo
ranks on the CPU, one iteration each at 2 arenas a rank, with a timeout.
It writes every field the JAX harness writes (the keys of its
``SCALING.json``) to the file asked for, and nothing at the repository's
root."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from reinforcement_learning_torch.tools import bench_scaling

ROOT = Path(__file__).resolve().parents[1]


def test_scaling_harness_writes_its_json(tmp_path):
    jax_json = ROOT / "SCALING.json"
    before = (jax_json.read_bytes(), jax_json.stat().st_mtime_ns)
    out = tmp_path / "scaling_torch.json"
    proc = subprocess.run(
        [sys.executable, "-m", "reinforcement_learning_torch.tools."
         "bench_scaling", "--devices", "1", "2", "--iters", "1",
         "--envs-per-device", "2", "--device", "cpu", "--timeout", "240",
         "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]

    got = json.loads(out.read_text())
    want = json.loads(jax_json.read_text())
    assert set(want) <= set(got)
    assert [r["n_devices"] for r in got["results"]] == [1, 2]
    for r in got["results"]:
        assert set(want["results"][0]) <= set(r)
        assert r["num_envs"] == 2 * r["n_devices"]
        assert r["steps_per_sec"] > 0 and r["seconds"] > 0
    assert got["results"][0]["efficiency_vs_1dev"] == 1.0
    assert got["device"] == "cpu" and "contention" in got["note"]

    # the default is under build/, and the JAX harness's file is untouched
    assert bench_scaling.DEFAULT_OUT == ROOT / "build" / "scaling_torch.json"
    assert not (ROOT / "scaling_torch.json").exists()
    assert (jax_json.read_bytes(), jax_json.stat().st_mtime_ns) == before
