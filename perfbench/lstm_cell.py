"""The LSTM cell's yardstick: the bytes one step of a per-lane cell has to
move, and the program's counters of the cell that its metrics read.

The port runs the cell (the gate products, the gates and the state update)
in the span ``policy.lstm_cell``, timed on the card's clock while a
profiler records (``span.policy.lstm_cell.device_seconds``), and counts the
rows it computed (``lstm.cell.lanes``) and the cell's sizes
(``lstm.cell.input_size``, ``lstm.cell.hidden_size``). A program without
them leaves the keys at 0, and every reading is then None.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["cell_bytes", "read_counters"]

_F32 = 4
DEVICE_SECONDS = "span.policy.lstm_cell.device_seconds"
LANES = "lstm.cell.lanes"
INPUT_SIZE = "lstm.cell.input_size"
HIDDEN_SIZE = "lstm.cell.hidden_size"


def cell_bytes(lanes: int, input_size: int, hidden_size: int) -> int:
    """One step of ``lanes`` float32 cells, each with weights of its own:
    reads the gate weights and biases, ``4H(I + H) + 8H``, once, and ``x``,
    ``h`` and ``c``; writes ``h'`` and ``c'``. The gates' intermediate
    values are the kernels' choice, not the operation's work, and are not
    counted."""
    i, h = int(input_size), int(hidden_size)
    weights = 4 * h * (i + h) + 8 * h
    return int(lanes) * (weights + i + 2 * h + 2 * h) * _F32


def read_counters() -> Optional[dict]:
    """The cell's counters of this process, its pending device times read
    in first; None where the program has no such counters or counted
    nothing."""
    from evotorch_tpu_torch.observability import counters, tracer

    resolve = getattr(tracer, "resolve_device_seconds", None)
    if resolve is None:
        return None
    resolve()
    values = counters.snapshot((DEVICE_SECONDS, LANES, INPUT_SIZE, HIDDEN_SIZE))
    if not all(values.values()):
        return None
    return {
        "device_seconds": float(values[DEVICE_SECONDS]),
        "lanes": int(values[LANES]),
        "input_size": int(values[INPUT_SIZE]),
        "hidden_size": int(values[HIDDEN_SIZE]),
    }
