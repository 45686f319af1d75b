"""Set-up seconds: process start to the first timed round (import, CUDA
context, kernel build or load, searcher, warm-up)."""


def read(summary):
    return summary["setup_s"]
