"""Host ms per call of the LSTM cell: the ``policy.lstm_cell`` span (the
gate products, the gates and the state update, as the host issues them),
per span counted in the traced segment (one a control step)."""

from perfbench.spans import per_step_ms


def read(summary):
    return per_step_ms("span.policy.lstm_cell.seconds", "span.policy.lstm_cell.count")
