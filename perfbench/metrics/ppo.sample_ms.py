"""Policy inference's host time per training call
(``PPOLearner.sample_actions``, no wait for the device): the mean of the
benchmark's ``ppo.sample`` span over the window's calls, in ms (host
clock)."""


def read(t):
    spans = t["spans"].get("ppo.sample")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1000
