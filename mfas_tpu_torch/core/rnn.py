"""Recurrent layers (port of mfas_tpu/core/rnn.py: the LSTM).

torch ``nn.LSTM(num_layers=1)`` semantics and ``state_dict`` names
(``weight_ih_l0``, ``weight_hh_l0``, ``bias_ih_l0``, ``bias_hh_l0``), gate
order i, f, g, o. Unlike ``nn.LSTM``, the initial weights come from the
explicit ``torch.Generator`` passed in, never from the global RNG:
U(-1/sqrt(H), 1/sqrt(H)) for all four, drawn in that order. The time loop
is a Python loop, one step per sequence element (the surrogate's sequences
are at most ``--max_fusions`` long). Time-major only: (T, B, in).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from mfas_tpu_torch.core import init as I


class LSTM(nn.Module):
    def __init__(self, input_size, hidden_size, *, device, generator):
        super().__init__()
        self.input_size = int(input_size)
        self.hidden_size = int(hidden_size)
        g, h, i = 4, self.hidden_size, self.input_size
        init = I.uniform(-1.0 / math.sqrt(h), 1.0 / math.sqrt(h))

        def draw(shape):
            return nn.Parameter(init(generator, shape, device))

        self.weight_ih_l0 = draw((g * h, i))
        self.weight_hh_l0 = draw((g * h, h))
        self.bias_ih_l0 = draw((g * h,))
        self.bias_hh_l0 = draw((g * h,))

    def forward(self, x, state=None):
        """x: (T, B, in) -> (outputs (T, B, H), (h_T, c_T))."""
        T, B = x.shape[0], x.shape[1]
        H = self.hidden_size
        if state is None:
            h = x.new_zeros((B, H))
            c = x.new_zeros((B, H))
        else:
            h, c = state
        x_proj = (torch.einsum("tbi,gi->tbg", x, self.weight_ih_l0)
                  + (self.bias_ih_l0 + self.bias_hh_l0))
        outs = []
        for t in range(T):
            z = x_proj[t] + h @ self.weight_hh_l0.T
            i_, f_, g_, o_ = z.chunk(4, dim=-1)
            c = torch.sigmoid(f_) * c + torch.sigmoid(i_) * torch.tanh(g_)
            h = torch.sigmoid(o_) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs), (h, c)
