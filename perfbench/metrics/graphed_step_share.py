"""Share of the budget contract's control steps whose bookkeeping the
program replayed from a CUDA graph: the program's counters
``rollout.graph.replayed_steps`` over it plus ``rollout.graph.eager_steps``
(the steps run eagerly: before the capture, or where no graph can be
captured), over the whole process, warm-up round included. None where no
budget step was counted, as in a program without these counters."""

REPLAYED = "rollout.graph.replayed_steps"
EAGER = "rollout.graph.eager_steps"


def read(summary):
    from evotorch_tpu_torch.observability import counters

    values = counters.snapshot((REPLAYED, EAGER))
    steps = values[REPLAYED] + values[EAGER]
    if steps <= 0:
        return None
    return values[REPLAYED] / steps
