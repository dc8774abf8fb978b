"""SimpleRNN, the character language model, and PTBModel, the LSTM
language model.

Counterpart of ``bigdl_tpu/models/rnn.py`` (reference
``models/rnn/SimpleRNN.scala:29-31``): ``SimpleRNN`` is
Recurrent(RnnCell(tanh)) + TimeDistributed(Linear) over one-hot
(batch, time, vocab) input; ``PTBModel`` is LookupTable -> stacked
Recurrent(LSTM) -> TimeDistributed(Linear) -> LogSoftMax over
(batch, time) token ids, trained with
``TimeDistributedCriterion(ClassNLLCriterion())``.
"""

from __future__ import annotations

import torch

from ..nn import (LSTM, Linear, LogSoftMax, LookupTable, Recurrent, RnnCell,
                  Sequential, TimeDistributed)

__all__ = ["SimpleRNN", "PTBModel"]


def SimpleRNN(input_size: int, hidden_size: int, output_size: int):
    return (Sequential()
            .add(Recurrent(RnnCell(input_size, hidden_size, torch.tanh)))
            .add(TimeDistributed(Linear(hidden_size, output_size))))


def PTBModel(vocab_size: int = 10000, embed_size: int = 200,
             hidden_size: int = 200, num_layers: int = 2,
             dropout: float = 0.0):
    """The PTB-style LSTM language model (``BASELINE.md`` config 5)."""
    model = Sequential().add(LookupTable(vocab_size, embed_size))
    in_size = embed_size
    for _ in range(num_layers):
        model.add(Recurrent(LSTM(in_size, hidden_size, p=dropout)))
        in_size = hidden_size
    model.add(TimeDistributed(Linear(hidden_size, vocab_size)))
    model.add(LogSoftMax())
    return model
