"""The benchmark's own arithmetic: the chip's peaks, the model FLOPs of the
policy, critic and shared head from their widths, and the least time of a
launch.  Nothing here reads the program: the widths come from the
configuration file.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity), which
assume the card's full 700 W; the harness prints the card's power limit
beside every share it reports.
"""

from __future__ import annotations

PEAK_BF16 = 989e12      # FLOP/s, tensor cores
PEAK_FP32 = 67e12       # FLOP/s, outside the tensor cores (TF32 off)
PEAK_HBM = 3.35e12      # bytes/s


def mlp_macs(num_inputs: int, layers, num_outputs: int = 0) -> int:
    """Multiply-accumulates of one row through Linear layers of widths
    ``layers`` (and an output layer of ``num_outputs`` when > 0)."""
    sizes = [num_inputs, *layers] + ([num_outputs] if num_outputs else [])
    return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def mlp_params(num_inputs: int, layers, num_outputs: int = 0,
               layer_norm: bool = True) -> int:
    """Parameters of such an MLP: weights, biases and, per hidden layer,
    LayerNorm's scale and bias."""
    sizes = [num_inputs, *layers] + ([num_outputs] if num_outputs else [])
    linear = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
    return linear + (2 * sum(layers) if layer_norm else 0)


def trio(config: dict) -> dict:
    """MACs per row of the shared head, policy and critic, and the
    parameter count of each, from a configuration file's widths."""
    ppo = config["ppo"]
    obs, actions = config["obs_size"], config["num_actions"]
    shared = list(ppo["shared_head_layers"])
    feat = shared[-1] if shared else obs
    ln = ppo["layer_norm"]
    return {
        "macs": {"shared_head": mlp_macs(obs, shared) if shared else 0,
                 "policy": mlp_macs(feat, ppo["policy_layers"], actions),
                 "critic": mlp_macs(feat, ppo["critic_layers"], 1)},
        "params": {"shared_head": (mlp_params(obs, shared, 0, ln)
                                   if shared else 0),
                   "policy": mlp_params(feat, ppo["policy_layers"], actions,
                                        ln),
                   "critic": mlp_params(feat, ppo["critic_layers"], 1, ln)},
    }


def least_time_s(config: dict, rows: dict) -> float:
    """The least time the chip needs for the model work of a window, each
    part at its precision's peak.  ``rows``: rows through the policy in
    bf16 inference (``sample``, the training collection's and the skill
    match's), through the critic in fp32 (``values``), and through the
    update's forward and backward passes in fp32 (``loss``: one forward
    of all three models and a backward of twice its work)."""
    m = trio(config)["macs"]
    policy = m["shared_head"] + m["policy"]
    critic = m["shared_head"] + m["critic"]
    whole = m["shared_head"] + m["policy"] + m["critic"]
    return (2 * policy * rows.get("sample", 0) / PEAK_BF16
            + 2 * policy * rows.get("match_sample", 0) / PEAK_BF16
            + 2 * critic * rows.get("values", 0) / PEAK_FP32
            + 3 * 2 * whole * rows.get("loss", 0) / PEAK_FP32)


def roofline_share(ops: float, nbytes: float, kernel_s: float) -> tuple:
    """(least time / kernel time, which bound sets the least time) of a
    launch that needs ``ops`` fp32 operations and moves ``nbytes``."""
    compute, memory = ops / PEAK_FP32, nbytes / PEAK_HBM
    return (max(compute, memory) / kernel_s,
            "compute" if compute >= memory else "memory")
