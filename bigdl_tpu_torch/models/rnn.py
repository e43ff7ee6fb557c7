"""Character / word-level RNN language model — the port of
``bigdl_tpu/models/rnn.py`` (ref: .../dllib/models/rnn/PTBModel.scala and
the SimpleRNN example: LookupTable → Recurrent(cell) x layers → Linear
over every timestep → LogSoftMax)."""

from __future__ import annotations

import bigdl_tpu_torch.nn as nn
from bigdl_tpu_torch.device import resolve_device


def build_model(input_size: int = 100, hidden_size: int = 40,
                output_size: int = 100, cell: str = "rnn",
                num_layers: int = 1, device=None) -> nn.Sequential:
    """``num_layers`` recurrent layers of ``cell`` ("rnn", "lstm" or
    "gru"), on ``device`` (``None``: the GPU)."""
    dev = resolve_device(device)
    cells = {"rnn": nn.RnnCell, "lstm": nn.LSTM, "gru": nn.GRU}
    if cell not in cells:
        raise ValueError(f"unknown cell {cell!r}")
    model = (nn.Sequential()
             .add(nn.LookupTable(input_size, hidden_size)))
    in_dim = hidden_size
    for _ in range(num_layers):
        mk = cells[cell]
        c = mk(in_dim, hidden_size) if cell != "rnn" else \
            mk(in_dim, hidden_size, "tanh")
        model.add(nn.Recurrent(c, return_sequences=True))
        in_dim = hidden_size
    return (model
            .add(nn.Linear(hidden_size, output_size))
            .add(nn.LogSoftMax())).to(dev)
