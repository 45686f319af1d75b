"""Percent of the window's wall time spent outside ``problem.evaluate``:
the searcher's ask, tell and adaptive-popsize loop (host clock at the round
boundaries)."""


def read(summary):
    if summary["window_s"] <= 0:
        return None
    return 100.0 * (summary["window_s"] - summary["eval_s"]) / summary["window_s"]
