"""Host ms per control step blocked on the card: the ``rollout.host_wait``
spans (the end poll's event wait, compaction's count, the round's
final read) over the traced segment's control steps. Near 0 while the
host is behind the card."""

from perfbench.spans import per_step_ms


def read(summary):
    return per_step_ms("span.rollout.host_wait.seconds")
