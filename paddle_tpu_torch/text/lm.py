"""The LSTM language model of Penn Treebank (``ptb_lm``). Counterpart of
``paddle_tpu/text/lm.py`` (``LSTMLanguageModel``).

An embedding, ``nn.LSTM`` (cuDNN's RNN layer by layer on the card) with
dropout on its input, between its layers and on its output, and a
``Linear`` to the vocabulary, or with ``tie_weights`` the embedding table
transposed plus a learned bias. Truncated backpropagation through time
carries ``state`` from one call to the next (detached by the caller).
Every weight is drawn from ``generator``, then the seed of the model's
``dropout_state``.
"""
import torch

from .. import nn
from ..device import resolve_device
from ..kernels.philox import DropoutState
from ..nn.initializer import create_parameter

__all__ = ['LSTMLanguageModel']


class LSTMLanguageModel(torch.nn.Module):
    def __init__(self, vocab_size, hidden_size=200, num_layers=2,
                 dropout=0.0, tie_weights=False, *, device=None,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.dropout_state = DropoutState(0)
        kw = dict(device=device, generator=generator)
        self.embedding = nn.Embedding(vocab_size, hidden_size, **kw)
        self.lstm = nn.LSTM(hidden_size, hidden_size, num_layers=num_layers,
                            dropout=dropout, dropout_state=self.dropout_state,
                            **kw)
        self.dropout = nn.Dropout(dropout, dropout_state=self.dropout_state)
        self.tie_weights = tie_weights
        if tie_weights:
            # the output projection is the (vocab, hidden) embedding table,
            # transposed; only a bias is its own
            self.out_bias = create_parameter((vocab_size,), None,
                                             is_bias=True, **kw)
        else:
            self.fc = nn.Linear(hidden_size, vocab_size, **kw)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout_state.seed = DropoutState.from_generator(generator).seed

    def forward(self, ids, state=None):
        """ids (B, T) -> (logits (B, T, vocab), (h, c) each (layers, B,
        hidden))."""
        x = self.dropout(self.embedding(ids))
        out, state = self.lstm(x, state)
        out = self.dropout(out)
        if self.tie_weights:
            logits = out.matmul(self.embedding.weight.T) + self.out_bias
        else:
            logits = self.fc(out)
        return logits, state

    def loss(self, logits, targets):
        return nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
