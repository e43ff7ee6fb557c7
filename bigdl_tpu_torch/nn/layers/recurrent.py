"""Recurrent layers — the port of ``bigdl_tpu/nn/layers/recurrent.py``
(ref: .../nn/Recurrent.scala, LSTM.scala, GRU.scala, RnnCell.scala,
BiRecurrent.scala).

A cell has ``init_carry(batch, dtype, device)`` and ``step(carry, x_t)
-> (carry, y_t)`` over its own parameters; :class:`Recurrent` runs the
time loop in Python over ``step`` (the JAX layer's ``lax.scan``), one
step a timestep, so autograd unrolls it. The weights keep the JAX
layout — ``w_ih`` ``(G * H, C)``, ``w_hh`` ``(G * H, H)``, LSTM's one
``bias`` (gates i, f, g, o), GRU's ``bias_ih`` and ``bias_hh`` (gates
r, z, n) — which is not cuDNN's (two LSTM biases), so neither
``torch.nn.LSTM`` nor cuDNN's RNN is used. ``RnnCell`` and ``GRU`` do
not cast their weights (the JAX cells promote a bf16 input to f32);
``LSTM`` casts them to the input's dtype, as the JAX cell does.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.initialization import Xavier, init_param
from bigdl_tpu_torch.nn.module import RNG, TensorModule


def _promoted(x, *ws):
    """``x`` and ``ws`` in their promoted dtype (JAX's promotion for a
    product of a bf16 input and f32 weights: f32)."""
    dt = x.dtype
    for w in ws:
        dt = torch.promote_types(dt, w.dtype)
    return (x.to(dt),) + tuple(w.to(dt) for w in ws)


class Cell(TensorModule):
    hidden_size: int

    def init_carry(self, batch: int, dtype=torch.float32, device=None):
        raise NotImplementedError

    def step(self, carry, x_t):
        raise NotImplementedError

    def forward(self, x):
        # a bare cell on (B, C) runs one step from zeros
        _, y = self.step(self.init_carry(x.shape[0], x.dtype, x.device), x)
        return y


class RnnCell(Cell):
    """Simple tanh (or relu) RNN cell (ref: nn/RnnCell.scala)."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation: str = "tanh", name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self.add_param("w_ih", init_param(
            Xavier(), RNG, (hidden_size, input_size), fan_in=input_size,
            fan_out=hidden_size))
        self.add_param("w_hh", init_param(
            Xavier(), RNG, (hidden_size, hidden_size), fan_in=hidden_size,
            fan_out=hidden_size))
        self.add_param("bias", torch.zeros(hidden_size))

    def init_carry(self, batch, dtype=torch.float32, device=None):
        return torch.zeros(batch, self.hidden_size, dtype=dtype,
                           device=device)

    def step(self, carry, x_t):
        act = torch.tanh if self.activation == "tanh" else torch.relu
        x_t, w_ih, w_hh, b = _promoted(x_t, self.w_ih, self.w_hh, self.bias)
        h = act(x_t @ w_ih.T + carry.to(x_t.dtype) @ w_hh.T + b)
        return h, h


class LSTM(Cell):
    """LSTM cell (ref: nn/LSTM.scala). Gate order: i, f, g, o."""

    def __init__(self, input_size: int, hidden_size: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.add_param("w_ih", init_param(
            Xavier(), RNG, (4 * hidden_size, input_size),
            fan_in=input_size, fan_out=hidden_size))
        self.add_param("w_hh", init_param(
            Xavier(), RNG, (4 * hidden_size, hidden_size),
            fan_in=hidden_size, fan_out=hidden_size))
        self.add_param("bias", torch.zeros(4 * hidden_size))

    def init_carry(self, batch, dtype=torch.float32, device=None):
        z = torch.zeros(batch, self.hidden_size, dtype=dtype, device=device)
        return z, z

    def step(self, carry, x_t):
        h, c = carry
        dt = x_t.dtype
        z = (x_t @ self.w_ih.T.to(dt) + h @ self.w_hh.T.to(dt)
             + self.bias.to(dt))
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
        return (h, c), h


class GRU(Cell):
    """GRU cell (ref: nn/GRU.scala). Gate order: r, z, n."""

    def __init__(self, input_size: int, hidden_size: int,
                 name: Optional[str] = None):
        super().__init__(name)
        self.input_size, self.hidden_size = input_size, hidden_size
        self.add_param("w_ih", init_param(
            Xavier(), RNG, (3 * hidden_size, input_size),
            fan_in=input_size, fan_out=hidden_size))
        self.add_param("w_hh", init_param(
            Xavier(), RNG, (3 * hidden_size, hidden_size),
            fan_in=hidden_size, fan_out=hidden_size))
        self.add_param("bias_ih", torch.zeros(3 * hidden_size))
        self.add_param("bias_hh", torch.zeros(3 * hidden_size))

    def init_carry(self, batch, dtype=torch.float32, device=None):
        return torch.zeros(batch, self.hidden_size, dtype=dtype,
                           device=device)

    def step(self, carry, x_t):
        x_t, w_ih, w_hh, b_ih, b_hh = _promoted(
            x_t, self.w_ih, self.w_hh, self.bias_ih, self.bias_hh)
        h = carry.to(x_t.dtype)
        ir, iz, in_ = torch.chunk(x_t @ w_ih.T + b_ih, 3, dim=-1)
        hr, hz, hn = torch.chunk(h @ w_hh.T + b_hh, 3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(in_ + r * hn)
        h = (1 - z) * n + z * h
        return h, h


class Recurrent(TensorModule):
    """A cell over time (ref: nn/Recurrent.scala container): (B, T, C) →
    (B, T, H), every timestep. With ``return_sequences=False`` the
    output is the loop's last step *before* a reverse is undone — for
    ``reverse=True`` that is the output at original t = 0, as in the
    JAX layer."""

    def __init__(self, cell: Optional[Cell] = None,
                 return_sequences: bool = True, reverse: bool = False,
                 name: Optional[str] = None):
        super().__init__(name)
        self.return_sequences = return_sequences
        self.reverse = reverse
        if cell is not None:
            self.add(cell)

    def add(self, cell: Cell):
        self._modules["cell"] = cell
        return self

    def forward(self, x):
        cell = self._modules["cell"]
        carry = cell.init_carry(x.shape[0], x.dtype, x.device)
        steps = range(x.shape[1] - 1, -1, -1) if self.reverse \
            else range(x.shape[1])
        ys = []
        for t in steps:
            carry, y = cell.step(carry, x[:, t])
            ys.append(y)
        if not self.return_sequences:
            return ys[-1]
        if self.reverse:
            ys.reverse()
        return torch.stack(ys, dim=1)


class BiRecurrent(TensorModule):
    """Bidirectional recurrent with a merge (ref: nn/BiRecurrent.scala)."""

    def __init__(self, cell_fwd: Cell, cell_bwd: Cell, merge: str = "concat",
                 name: Optional[str] = None):
        super().__init__(name)
        self.fwd = Recurrent(cell_fwd)
        self.bwd = Recurrent(cell_bwd, reverse=True)
        self.merge = merge

    def forward(self, x):
        yf, yb = self.fwd(x), self.bwd(x)
        if self.merge == "concat":
            return torch.cat([yf, yb], dim=-1)
        if self.merge == "sum":
            return yf + yb
        raise ValueError(f"unknown merge {self.merge}")
