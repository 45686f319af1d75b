"""The LSTM cell's share of its roofline in the traced segment: the bytes
its steps have to move (``lstm_cell.cell_bytes`` over the lanes the
program counted) at 3.35 TB/s, over the span ``policy.lstm_cell``'s time
on the card's clock. That time runs from the span's first launch to its
last kernel's end, the gates' elementwise kernels and any launch gap
inside included, so the share is a lower bound of the gate products'."""

from perfbench import lstm_cell, roofline


def read(summary):
    c = lstm_cell.read_counters()
    if c is None:
        return None
    nbytes = lstm_cell.cell_bytes(c["lanes"], c["input_size"], c["hidden_size"])
    return roofline.roofline_share(c["device_seconds"], nbytes=nbytes)
