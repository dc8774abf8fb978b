"""Text data pipeline: sentence splitting and tokenization, the
``Dictionary``, and the labeled-sentence transformers.

Counterpart of ``bigdl_tpu/dataset/text.py`` (reference
``dataset/text/``: ``SentenceSplitter``, ``SentenceTokenizer``,
``Dictionary``, ``TextToLabeledSentence``, ``LabeledSentenceToSample``,
``SentenceBiPadding``; the char-RNN pipeline of
``models/rnn/Train.scala:49-96``), with the same regular expressions and
the same ``Dictionary`` file, so a vocabulary saved by either package
loads in the other."""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from .sample import Sample
from .transformer import Transformer

__all__ = ["SentenceSplitter", "SentenceTokenizer", "SentenceBiPadding",
           "Dictionary", "LabeledSentence", "TextToLabeledSentence",
           "LabeledSentenceToSample"]

SENTENCE_START = "SENTENCESTART"
SENTENCE_END = "SENTENCEEND"


class SentenceSplitter(Transformer):
    """Split a document string into sentences
    (dataset/text/SentenceSplitter.scala; regex instead of OpenNLP)."""

    _pattern = re.compile(r"(?<=[.!?])\s+")

    def __call__(self, prev: Iterator[str]) -> Iterator[List[str]]:
        for doc in prev:
            sents = [s.strip() for s in self._pattern.split(doc.strip())]
            yield [s for s in sents if s]


class SentenceTokenizer(Transformer):
    """Sentence string -> token array
    (dataset/text/SentenceTokenizer.scala)."""

    _pattern = re.compile(r"\w+(?:'\w+)?|[^\w\s]")

    def __call__(self, prev: Iterator[str]) -> Iterator[List[str]]:
        for sentence in prev:
            yield self._pattern.findall(sentence.lower())


class SentenceBiPadding(Transformer):
    """Wrap token lists with start/end markers
    (dataset/text/SentenceBiPadding.scala)."""

    def __init__(self, start: str = SENTENCE_START, end: str = SENTENCE_END):
        self.start = start
        self.end = end

    def __call__(self, prev: Iterator[List[str]]) -> Iterator[List[str]]:
        for tokens in prev:
            yield [self.start] + list(tokens) + [self.end]


class Dictionary:
    """Token vocabulary with frequency-ranked truncation
    (dataset/text/Dictionary.scala): keeps the `vocab_size` most frequent
    words, maps the rest to an out-of-vocabulary bucket."""

    UNK = "<unk>"

    def __init__(self, sentences: Optional[Iterable[Sequence[str]]] = None,
                 vocab_size: Optional[int] = None):
        self._word2index: Dict[str, int] = {}
        self._index2word: List[str] = []
        if sentences is not None:
            counts = Counter(tok for sent in sentences for tok in sent)
            if vocab_size is not None and vocab_size < len(counts):
                kept = [w for w, _ in counts.most_common(vocab_size)]
            else:
                kept = sorted(counts, key=lambda w: (-counts[w], w))
            self._index2word = list(kept) + [self.UNK]
            self._word2index = {w: i for i, w in enumerate(self._index2word)}

    # -- lookups (Dictionary.scala getIndex/getWord/...) --

    def vocab_size(self) -> int:
        return len(self._index2word)

    def unk_index(self) -> int:
        """The out-of-vocabulary index — PINNED contract: the UNK token is
        always the LAST index (``vocab_size() - 1``), on construction and
        across save/load round-trips.  Models size their LookupTable as
        ``Dictionary.vocab_size()`` and training/serving both map unseen
        words here, so this index moving would silently scramble
        embeddings between a trained checkpoint and its server."""
        return self._word2index.get(self.UNK, 0)

    def get_index(self, word: str) -> int:
        return self._word2index.get(word,
                                    self._word2index.get(self.UNK, 0))

    def get_word(self, index: int) -> str:
        return self._index2word[index]

    def word2index(self) -> Dict[str, int]:
        return dict(self._word2index)

    def index2word(self) -> List[str]:
        return list(self._index2word)

    def encode(self, tokens: Sequence[str]) -> np.ndarray:
        return np.array([self.get_index(t) for t in tokens], dtype=np.int32)

    # -- persistence: ``dictionary.json`` through utils/file_io (atomic
    # local writes, retried remote IO), the reference's format name kept
    # so that either package reads the other's file

    def save(self, path: str) -> None:
        from ..utils import file_io
        fs = file_io.get_filesystem(path)
        fs.makedirs(path)
        payload = {"format": "bigdl_tpu-dictionary-v1",
                   "index2word": list(self._index2word)}
        fs.write_bytes(os.path.join(path, "dictionary.json"),
                       json.dumps(payload).encode("utf-8"))

    @classmethod
    def load(cls, path: str) -> "Dictionary":
        from ..utils import file_io
        fs = file_io.get_filesystem(path)
        raw = json.loads(fs.read_bytes(
            os.path.join(path, "dictionary.json")).decode("utf-8"))
        if isinstance(raw, dict):
            if raw.get("format") != "bigdl_tpu-dictionary-v1":
                raise ValueError(
                    f"{path!r}: unrecognized dictionary format "
                    f"{raw.get('format')!r}")
            words = raw["index2word"]
        else:  # legacy pre-v1 files: a bare JSON list
            words = raw
        d = cls()
        d._index2word = list(words)
        d._word2index = {w: i for i, w in enumerate(d._index2word)}
        if d._index2word and d._index2word[-1] != cls.UNK:
            raise ValueError(
                f"{path!r}: dictionary breaks the pinned UNK contract "
                f"(last index must be {cls.UNK!r}, got "
                f"{d._index2word[-1]!r})")
        return d


class LabeledSentence:
    """A (data indices, label indices) pair
    (dataset/text/LabeledSentence.scala)."""

    def __init__(self, data: np.ndarray, label: np.ndarray):
        self.data = np.asarray(data)
        self.label = np.asarray(label)

    def data_length(self) -> int:
        return len(self.data)

    def label_length(self) -> int:
        return len(self.label)


class TextToLabeledSentence(Transformer):
    """Token list -> language-model LabeledSentence: data = w[0..n-1],
    label = w[1..n] (dataset/text/TextToLabeledSentence.scala)."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def __call__(self, prev: Iterator[List[str]]) -> Iterator[LabeledSentence]:
        for tokens in prev:
            if len(tokens) < 2:
                continue
            idx = self.dictionary.encode(tokens)
            yield LabeledSentence(idx[:-1], idx[1:])


class LabeledSentenceToSample(Transformer):
    """LabeledSentence -> Sample, either one-hot vectors of size
    `vocab_length` or plain index arrays; optional fixed lengths with
    padding (dataset/text/LabeledSentenceToSample.scala)."""

    def __init__(self, vocab_length: Optional[int] = None,
                 fixed_data_length: Optional[int] = None,
                 fixed_label_length: Optional[int] = None,
                 label_pad_value: float = -1.0):
        self.vocab_length = vocab_length
        self.fixed_data_length = fixed_data_length
        self.fixed_label_length = fixed_label_length
        # -1 = the criterion-side ignore index (ClassNLLCriterion masks
        # negative labels); 0 would be a real class under 0-based labels
        self.label_pad_value = label_pad_value

    def _pad(self, arr: np.ndarray, length: Optional[int], pad_value):
        if length is None or len(arr) == length:
            return arr
        if len(arr) > length:
            return arr[:length]
        pad = np.full((length - len(arr),) + arr.shape[1:], pad_value,
                      dtype=arr.dtype)
        return np.concatenate([arr, pad])

    def __call__(self, prev: Iterator[LabeledSentence]) -> Iterator[Sample]:
        for ls in prev:
            if self.vocab_length is not None:
                data = np.zeros((ls.data_length(), self.vocab_length),
                                dtype=np.float32)
                data[np.arange(ls.data_length()), ls.data] = 1.0
                data = self._pad(data, self.fixed_data_length, 0.0)
            else:
                data = self._pad(ls.data.astype(np.int32),
                                 self.fixed_data_length, 0)
            # labels stay 0-based; padding is -1, which ClassNLLCriterion
            # ignores
            label = self._pad(ls.label.astype(np.float32),
                              self.fixed_label_length, self.label_pad_value)
            yield Sample(data, label)
