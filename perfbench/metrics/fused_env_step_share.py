"""Share of the rigid-body envs' steps whose observation, reward and done
the physics kernel's epilogue produced: the program's counters
``env.step.fused`` over it plus ``env.step.eager`` (the steps the plain
path took), over the whole process, warm-up round included. None where no
such step was counted, as in a program without these counters."""

FUSED = "env.step.fused"
EAGER = "env.step.eager"


def read(summary):
    from evotorch_tpu_torch.observability import counters

    values = counters.snapshot((FUSED, EAGER))
    steps = values[FUSED] + values[EAGER]
    if steps <= 0:
        return None
    return values[FUSED] / steps
