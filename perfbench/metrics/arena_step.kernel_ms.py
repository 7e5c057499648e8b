"""The arena-step kernel's device time per training launch, in ms: the
mean over the traced iteration's training launches in the profiler's
trace."""


def read(t):
    launches = t.get("training_launch_s")
    if not launches:
        return None
    return sum(launches) / len(launches) * 1000
