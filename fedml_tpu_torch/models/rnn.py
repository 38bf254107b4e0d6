"""Federated RNNs (port of ``fedml_tpu/models/rnn.py``).

- ``RNNOriginalFedAvg``: the McMahan et al. (2017) Shakespeare char-LM,
  embedding(8) -> 2x LSTM(256) -> dense(vocab); 820,522 params at
  vocab 90.
- ``RNNStackOverflow``: Stack Overflow next-word prediction,
  embedding(96) -> LSTM(670) -> dense(96) -> dense(vocab); 4,050,748
  params at vocab 10,004.

The LSTM is flax's ``OptimizedLSTMCell`` run over time by ``nn.RNN``,
written as explicit products and elementwise ops over a Python loop in
time, not ``nn.LSTM``: under the trainer's ``vmap(grad)`` these fold
the cohort into batched products, where ``nn.LSTM``'s fused kernel has
no batching rule and falls back to one call per client. The input
product of all time steps is hoisted out of the loop as one GEMM.

Module names are flax's (``Embed_0``, ``OptimizedLSTMCell_k``,
``Dense_k``), so ``convert.params_from_flax`` maps a JAX checkpoint key
for key; each cell stacks flax's four gate kernels i, f, g, o into one
weight.
"""

from __future__ import annotations

import torch
from torch import nn


class OptimizedLSTM(nn.Module):
    """flax ``nn.RNN(nn.OptimizedLSTMCell(hidden))``: inputs ``[B, T,
    in]`` -> hidden states ``[B, T, hidden]``, the carry starting at
    zero. Gates i, f, g, o (sigmoid on i, f and o, tanh on g);
    ``c' = f*c + i*g``, ``h' = o*tanh(c')``. ``ih`` stacks the bias-free
    input kernels ``ii/if/ig/io``, ``hh`` the hidden kernels
    ``hi/hf/hg/ho`` and their biases, each ``[4*hidden, ...]`` in that
    order."""

    def __init__(self, in_features: int, hidden: int) -> None:
        super().__init__()
        self.hidden = hidden
        self.ih = nn.Linear(in_features, 4 * hidden, bias=False)
        self.hh = nn.Linear(hidden, 4 * hidden)

    @property
    def orthogonal_blocks(self):
        """flax initializes each hidden kernel orthogonal
        (``FedModel.init`` reads this): ``hh.weight`` in blocks of
        ``hidden`` rows, one per gate."""
        return {"hh.weight": self.hidden}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, _ = x.shape
        xi = self.ih(x)  # every time step's input product, one GEMM
        h = x.new_zeros((B, self.hidden))
        c = x.new_zeros((B, self.hidden))
        out = []
        for t in range(T):
            i, f, g, o = (self.hh(h) + xi[:, t]).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class RNNOriginalFedAvg(nn.Module):
    """Tokens ``[B, T]`` -> logits ``[B, T, vocab]``."""

    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8,
                 hidden_size: int = 256) -> None:
        super().__init__()
        self.Embed_0 = nn.Embedding(vocab_size, embedding_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTM(embedding_dim, hidden_size)
        self.OptimizedLSTMCell_1 = OptimizedLSTM(hidden_size, hidden_size)
        self.Dense_0 = nn.Linear(hidden_size, vocab_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.OptimizedLSTMCell_0(self.Embed_0(x))
        return self.Dense_0(self.OptimizedLSTMCell_1(h))


class RNNStackOverflow(nn.Module):
    """Tokens ``[B, T]`` -> logits ``[B, T, vocab]``; vocab 10,000 words
    and pad/bos/eos/oov."""

    def __init__(self, vocab_size: int = 10004, embedding_dim: int = 96,
                 hidden_size: int = 670) -> None:
        super().__init__()
        self.Embed_0 = nn.Embedding(vocab_size, embedding_dim)
        self.OptimizedLSTMCell_0 = OptimizedLSTM(embedding_dim, hidden_size)
        self.Dense_0 = nn.Linear(hidden_size, embedding_dim)
        self.Dense_1 = nn.Linear(embedding_dim, vocab_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.OptimizedLSTMCell_0(self.Embed_0(x))
        return self.Dense_1(self.Dense_0(h))
