"""Federated NLP RNNs (counterpart of ``fedml_tpu/model/nlp/rnn.py``):
``RNNShakespeare`` (the FedAvg paper's model: embedding 8, 2 x LSTM 256,
per-token vocab logits) and ``RNNStackOverflow`` (embedding 96, LSTM 670,
Dense 96, vocab 10,004).

The LSTM is flax's ``nn.RNN(nn.OptimizedLSTMCell(h))`` with a zero carry:
gates i, f, g, o; ``c' = sigmoid(f) c + sigmoid(i) tanh(g)``, ``h' =
sigmoid(o) tanh(c')``. Its parameters keep flax's names and layouts, so
they cross to and from a flax tree unchanged: ``OptimizedLSTMCell_k`` at
the model's top level holds the input kernels ``ii``/``if``/``ig``/``io``
(``[in, h]``, no bias) and the hidden kernels ``hi``/``hf``/``hg``/``ho``
(``[h, h]``) with their biases. A forward concatenates each group into one
``[in, 4h]`` / ``[h, 4h]`` matrix, projects every time step's input at
once, and runs the recurrence as one ``[bs, h] x [h, 4h]`` product per
step: plain matmuls, which a CUDA graph captures and the FLOP counter
sees (cuDNN's fused LSTM is neither counted by
``torch.utils.flop_counter`` nor needed for the round's parity).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..cv.resnet import init_dense_, lecun_normal_

GATES = ("i", "f", "g", "o")


class _DenseParams(nn.Module):
    """One flax ``DenseParams`` scope: ``kernel`` ``[in, out]`` and, for
    the hidden kernels, ``bias``."""

    def __init__(self, fan_in: int, features: int, bias: bool):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fan_in, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if bias
                     else None)


class LSTMLayer(nn.Module):
    """``nn.RNN(nn.OptimizedLSTMCell(hidden))`` over ``[bs, L, in]``."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in GATES:
            self.add_module(f"i{g}", _DenseParams(in_features, hidden, False))
            self.add_module(f"h{g}", _DenseParams(hidden, hidden, True))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisers: lecun_normal input kernels, orthogonal
        hidden kernels, zero biases."""
        with torch.no_grad():
            for g in GATES:
                k = getattr(self, f"i{g}").kernel
                lecun_normal_(k, k.shape[0], generator)
                h = getattr(self, f"h{g}")
                nn.init.orthogonal_(h.kernel, generator=generator)
                h.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mods = [getattr(self, f"{s}{g}") for s in "ih" for g in GATES]
        wi = torch.cat([m.kernel for m in mods[:4]], dim=-1).to(x.dtype)
        wh = torch.cat([m.kernel for m in mods[4:]], dim=-1).to(x.dtype)
        bh = torch.cat([m.bias for m in mods[4:]]).to(x.dtype)
        bs, steps, _ = x.shape
        xi = x @ wi                                   # [bs, L, 4h]
        h = x.new_zeros(bs, self.hidden)
        c = x.new_zeros(bs, self.hidden)
        out = []
        for t in range(steps):
            # flax: (h @ Wh + b) + x @ Wi, then the gates
            z = torch.addmm(bh, h, wh) + xi[:, t]
            i, f, g, o = z.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out, dim=1)


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding`` ``[vocab, features]``."""

    def __init__(self, vocab: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax's variance_scaling(1, fan_in, normal) over the features
        with torch.no_grad():
            self.embedding.normal_(
                0.0, 1.0 / math.sqrt(self.embedding.shape[1]),
                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embedding[x.long()]


class _RNN(nn.Module):
    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, (LSTMLayer, Embed)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Linear):
                init_dense_(m, generator)


class RNNShakespeare(_RNN):
    """``[bs, L]`` int tokens -> ``[bs, L, vocab]`` logits."""

    def __init__(self, vocab_size: int = 90, embedding_dim: int = 8,
                 hidden_size: int = 256, num_layers: int = 2):
        super().__init__()
        self.Embed_0 = Embed(vocab_size, embedding_dim)
        self.num_layers = num_layers
        for k in range(num_layers):
            self.add_module(f"OptimizedLSTMCell_{k}", LSTMLayer(
                embedding_dim if k == 0 else hidden_size, hidden_size))
        self.Dense_0 = nn.Linear(hidden_size, vocab_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Embed_0(x)
        for k in range(self.num_layers):
            h = getattr(self, f"OptimizedLSTMCell_{k}")(h)
        return self.Dense_0(h)


class RNNStackOverflow(_RNN):
    """Next-word prediction: embedding, one LSTM, Dense to the embedding
    width, Dense to the vocabulary."""

    def __init__(self, vocab_size: int = 10004, embedding_dim: int = 96,
                 hidden_size: int = 670):
        super().__init__()
        self.Embed_0 = Embed(vocab_size, embedding_dim)
        self.OptimizedLSTMCell_0 = LSTMLayer(embedding_dim, hidden_size)
        self.Dense_0 = nn.Linear(hidden_size, embedding_dim)
        self.Dense_1 = nn.Linear(embedding_dim, vocab_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.OptimizedLSTMCell_0(self.Embed_0(x))
        return self.Dense_1(self.Dense_0(h))
