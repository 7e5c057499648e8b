"""One skill match's time (``SkillTracker.run_matches``, its end waiting
for the device): the mean of the benchmark's ``selfplay.match`` span
over the window's calls, in s (host clock)."""


def read(t):
    spans = t["spans"].get("selfplay.match")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1
