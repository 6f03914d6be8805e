"""The word-level LSTM language model of the PyTorch port.

Counterpart of the ``RNNModel`` of ``example/rnn/word_lm/train.py``
(reference: example/rnn/word_lm/model.py): Embedding -> Dropout -> LSTM
(layout TNC, dropout between layers) -> Dropout -> Dense over the
vocabulary, with the same structural parameter names (``encoder.weight``,
``rnn.l0_i2h_weight``, ..., ``decoder.weight``, ``decoder.bias``).  The
LSTM's and the decoder's input widths are deferred, as in the example.
It is a :class:`HybridBlock`, as upstream MXNet's word-LM model is, so
``hybridize()`` captures the whole forward (with the states) as one
program.

``PTB_MEDIUM`` is the "medium" LSTM of Zaremba, Sutskever and Vinyals
2014 (arXiv:1409.2329, section 4.1), TensorFlow's ``MediumConfig``.  Its
learning rate and clip norm are the paper's, for the paper's loss: the
per-token losses summed over the ``bptt`` steps and averaged over the
batch.  With ``SoftmaxCrossEntropyLoss`` (a loss per token) that is
``autograd.backward(loss)``, ``clip_global_norm(grads, clip *
batch_size)`` and ``trainer.step(batch_size)``.  ``synthetic_corpus``
and ``batchify`` are the example's, for a vocabulary whose text is not at
hand.
"""

from __future__ import annotations

import numpy as np

from .. import nn, rnn
from ..block import HybridBlock

__all__ = ["RNNModel", "PTB_MEDIUM", "synthetic_corpus", "batchify",
           "detach"]

PTB_MEDIUM = dict(vocab=10000, num_embed=650, num_hidden=650, num_layers=2,
                  dropout=0.5, bptt=35, batch_size=20, init_scale=0.05,
                  lr=1.0, clip=5.0)


class RNNModel(HybridBlock):
    """``(decoded (T * N, vocab), states)`` from ids (T, N) and the
    LSTM's states ``[h, c]``."""

    _port_native = True

    def __init__(self, vocab_size, num_embed, num_hidden, num_layers,
                 dropout=0.5, *, device=None):
        super().__init__(device=device)
        self.drop = nn.Dropout(dropout, device=self.device)
        self.encoder = nn.Embedding(vocab_size, num_embed,
                                    device=self.device)
        self.rnn = rnn.LSTM(num_hidden, num_layers, dropout=dropout,
                            layout="TNC", device=self.device)
        self.decoder = nn.Dense(vocab_size, flatten=False,
                                device=self.device)
        self.num_hidden = num_hidden

    def forward(self, inputs, hidden):
        emb = self.drop(self.encoder(inputs))
        output, hidden = self.rnn(emb, hidden)
        output = self.drop(output)
        decoded = self.decoder(output.reshape(-1, self.num_hidden))
        return decoded, hidden

    def begin_state(self, *args, **kwargs):
        return self.rnn.begin_state(*args, **kwargs)


def synthetic_corpus(num_tokens=20000, vocab=200, seed=0, noise=0.05):
    """A fixed random cycle over the vocabulary with a share ``noise`` of
    tokens replaced at random, as float32 ids: an LM that learns the
    cycle reaches a low perplexity."""
    rng = np.random.RandomState(seed)
    cycle = rng.permutation(vocab)
    toks = np.tile(cycle, num_tokens // vocab + 1)[:num_tokens]
    flip = rng.rand(num_tokens) < noise
    toks[flip] = rng.randint(0, vocab, flip.sum())
    return toks.astype(np.float32), vocab


def batchify(data, batch_size):
    """The corpus as (T, batch_size) columns."""
    n = len(data) // batch_size
    return data[:n * batch_size].reshape(batch_size, n).T


def detach(hidden):
    """The states cut from the graph of the batch that made them."""
    if isinstance(hidden, (list, tuple)):
        return [detach(h) for h in hidden]
    return hidden.detach()
