"""The port stands alone: no module of it, and none of ``chip_smoke.py``,
``kernel_variants.py`` and ``bench_torch.py``, imports JAX (or
flax/optax), the JAX package or ``tools``."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "reinforcement_learning_tpu",
             "tools")
FILES = sorted((ROOT / "reinforcement_learning_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_variants.py",
    ROOT / "bench_torch.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_the_port_has_its_modules():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for mod in ("constants", "maths", "physics/state", "physics/step",
                "ops/pack", "ops/ctick", "ops/arena_step", "envs/env",
                "envs/obs", "models/mlp", "learn/ppo", "learn/trainer",
                "learn/gae", "learn/welford", "learn/optim",
                "learn/selfplay", "learn/transfer", "envs/rewards",
                "envs/kickoff_reward", "envs/terminals", "envs/shard",
                "envs/state_setters", "utils/checkpoint", "utils/metrics",
                "utils/report", "utils/render", "utils/keypress",
                "examples/train_2v2", "examples/train_1v1",
                "deploy/native", "deploy/infer", "deploy/bot_bridge",
                "deploy/rlbot_agent", "deploy/rlbot_packet_agent",
                "tools/checkpoint_converter", "physics/box_tri",
                "physics/box_box", "physics/mesh", "physics/arena_geom",
                "physics/world", "physics/car", "physics/contacts",
                "physics/ball_pred", "parallel/mesh",
                "tools/bench_scaling", "tools/parity", "tools/parity_battery",
                "tools/parity_teacher", "tools/parity_debug",
                "tools/parity_kdebug", "tools/profile_split",
                "tools/profile_phys"):
        assert f"reinforcement_learning_torch/{mod}.py" in names, mod
    assert (ROOT / "reinforcement_learning_torch/csrc/arena_step.cu").exists()
    for src in ("mlp_infer.cpp", "bot_server.cpp"):
        assert (ROOT / "reinforcement_learning_torch/deploy/native"
                / src).exists(), src


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.name} imports {sorted(bad)}"
