"""The arena-step kernel's device time per car-tick, in ns: the mean over
the traced iteration's training launches of their device time in the
profiler's trace (as ``arena_step.kernel_ms`` reads it), over the
car-ticks one launch steps, arenas x cars x ``tick_skip`` as the cell's
configuration gives them: the unit the port's counter
``kernel.car_ticks`` counts, in which launches of 4 and 6 cars compare."""


def car_ticks(config: dict) -> int:
    """Car-ticks of one training launch of ``config``."""
    env = config["env"]
    return env["num_envs"] * 2 * env["team_size"] * env["tick_skip"]


def read(t):
    launches = t.get("training_launch_s")
    if not launches or not t.get("config"):
        return None
    return sum(launches) / len(launches) / car_ticks(t["config"]) * 1e9
