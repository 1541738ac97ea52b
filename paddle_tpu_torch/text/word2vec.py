"""word2vec: skip-gram with negative sampling. Counterpart of
``paddle_tpu/text/word2vec.py`` (``SkipGram``, also ``Word2Vec``).

The loss of each (center, context) pair is ``-log σ(c·o) - Σ_k log
σ(-c·n_k)`` over its negatives, averaged over the batch. Negatives not
given are drawn uniformly from the vocabulary on the model's explicit
``negative_generator`` (one on the device seeded with 0 unless
``generator`` is given).
"""
import torch

from .. import nn
from ..device import resolve_device

__all__ = ['SkipGram', 'Word2Vec']


class SkipGram(torch.nn.Module):
    def __init__(self, vocab_size, embedding_dim=128, neg_samples=5, *,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.neg_samples = neg_samples
        kw = dict(device=device, generator=generator)
        self.in_embed = nn.Embedding(vocab_size, embedding_dim, **kw)
        self.out_embed = nn.Embedding(vocab_size, embedding_dim, **kw)
        self.negative_generator = generator if generator is not None \
            else torch.Generator(device=device).manual_seed(0)

    def forward(self, center, context, negatives=None):
        """center, context (B,) ids; negatives (B, k) -> the scalar loss."""
        if negatives is None:
            negatives = torch.randint(
                0, self.vocab_size, (center.shape[0], self.neg_samples),
                generator=self.negative_generator, device=center.device)
        c = self.in_embed(center)                        # (B, d)
        pos = self.out_embed(context)                    # (B, d)
        neg = self.out_embed(negatives)                  # (B, k, d)
        pos_score = (c * pos).sum(-1)
        neg_score = (neg * c.unsqueeze(1)).sum(-1)
        pos_loss = nn.functional.log_sigmoid(pos_score)
        neg_loss = nn.functional.log_sigmoid(-neg_score).sum(-1)
        return -(pos_loss + neg_loss).mean()

    def embedding(self):
        return self.in_embed.weight


Word2Vec = SkipGram
