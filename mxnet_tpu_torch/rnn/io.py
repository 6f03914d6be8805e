"""Bucketed sentences for the symbolic recurrent path of the PyTorch port.

Counterpart of ``mxnet_tpu/rnn/io.py`` (reference: python/mxnet/rnn/io.py).
``BucketSentenceIter`` pads each sentence to the smallest bucket length
that holds it; a batch is one bucket's rows, its label the data shifted
left by one token, and its ``bucket_key`` the length, for which a
``BucketingModule`` keeps one executor (one captured CUDA graph on the
card).  ``reset`` draws from Python's ``random`` and numpy's global
generator exactly as the JAX package's does, so that under one seed both
give the same batches in the same order.  Batches are NDArrays on the
host; the executor copies them to its device.
"""

from __future__ import annotations

import bisect
import logging
import random

import numpy as np

from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter
from ..ndarray import array

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Sentences of tokens as lists of integer ids, and the vocabulary,
    grown as tokens first appear unless one is given (reference: io.py
    encode_sentences)."""
    grow = vocab is None
    if grow:
        vocab = {invalid_key: invalid_label}
    next_id = start_label
    encoded = []
    for sent in sentences:
        ids = []
        for token in sent:
            if token not in vocab:
                if not (grow or unknown_token):
                    raise ValueError("unknown token %r with a frozen "
                                     "vocabulary" % (token,))
                if unknown_token:
                    token = unknown_token
                if token not in vocab:
                    if next_id == invalid_label:
                        next_id += 1
                    vocab[token] = next_id
                    next_id += 1
            ids.append(vocab[token])
        encoded.append(ids)
    return encoded, vocab


class BucketSentenceIter(DataIter):
    """A language model's iterator over bucketed sentences (reference:
    io.py BucketSentenceIter): batches with ``bucket_key`` set, layout
    ``"NT"`` (batch-major) or ``"TN"``."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label",
                 dtype="float32", layout="NT"):
        super().__init__(batch_size=batch_size)
        self.batch_size = batch_size
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError("layout must be 'NT' (batch-major) or 'TN' "
                             "(time-major), got %r" % (layout,))

        if not buckets:
            # every length that fills at least one batch
            counts = np.bincount([len(s) for s in sentences])
            buckets = [length for length, c in enumerate(counts)
                       if c >= batch_size]
        buckets = sorted(buckets)

        per_bucket = [[] for _ in buckets]
        discarded = 0
        for sent in sentences:
            slot = bisect.bisect_left(buckets, len(sent))
            if slot == len(buckets):
                discarded += 1
                continue
            row = np.full((buckets[slot],), invalid_label, dtype=dtype)
            row[:len(sent)] = sent
            per_bucket[slot].append(row)
        if discarded:
            logging.warning("BucketSentenceIter: discarded %d sentences "
                            "longer than the largest bucket", discarded)
        kept = [(b, rows) for b, rows in zip(buckets, per_bucket) if rows]
        self.buckets = [b for b, _ in kept]
        self.data = [np.asarray(rows, dtype=dtype) for _, rows in kept]
        if not self.buckets:
            raise ValueError("no bucket holds a full batch; lower "
                             "batch_size or pass explicit buckets")
        self.default_bucket_key = max(self.buckets)

        shape = (batch_size, self.default_bucket_key) \
            if self.major_axis == 0 else \
            (self.default_bucket_key, batch_size)
        self.provide_data = [DataDesc(name=data_name, shape=shape,
                                      layout=layout)]
        self.provide_label = [DataDesc(name=label_name, shape=shape,
                                       layout=layout)]
        self.idx = []
        self.nddata = []
        self.ndlabel = []
        self.curr_idx = 0
        self.reset()

    def reset(self):
        """Shuffle the order of the batches across buckets and the rows
        within each bucket."""
        self.curr_idx = 0
        self.idx = [(i, j) for i, rows in enumerate(self.data)
                    for j in range(0, len(rows) - self.batch_size + 1,
                                   self.batch_size)]
        random.shuffle(self.idx)
        self.nddata, self.ndlabel = [], []
        for rows in self.data:
            np.random.shuffle(rows)
            label = np.full_like(rows, self.invalid_label)
            label[:, :-1] = rows[:, 1:]
            self.nddata.append(array(rows, ctx=cpu(), dtype=self.dtype))
            self.ndlabel.append(array(label, ctx=cpu(), dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        if self.major_axis == 1:
            data, label = data.T, label.T
        return DataBatch(
            [data], [label], pad=0, bucket_key=self.buckets[i],
            provide_data=[DataDesc(name=self.data_name, shape=data.shape,
                                   layout=self.layout)],
            provide_label=[DataDesc(name=self.label_name, shape=label.shape,
                                    layout=self.layout)])
