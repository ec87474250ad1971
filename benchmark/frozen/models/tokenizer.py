"""Minimal BERT WordPiece tokenizer: the port's copy of
``vlfm_tpu/models/tokenizer.py``.

Lowercasing, punctuation splitting, greedy longest-match WordPiece with
``##`` continuations, [CLS]/[SEP] specials and padding to a fixed length.
``encode_batch`` returns torch tensors; the ids equal the JAX package's.
"""

from __future__ import annotations

import string
from typing import Dict, List, Sequence, Tuple

import torch


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], max_len: int = 32):
        self.vocab = vocab
        self.max_len = max_len
        self.cls_id = vocab.get("[CLS]", 0)
        self.sep_id = vocab.get("[SEP]", 0)
        self.pad_id = vocab.get("[PAD]", 0)
        self.unk_id = vocab.get("[UNK]", 0)

    @classmethod
    def from_vocab_file(cls, path: str, max_len: int = 32) -> "WordPieceTokenizer":
        """A BERT ``vocab.txt``: one token per line, its id the line number."""
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, max_len)

    @staticmethod
    def _basic_tokenize(text: str) -> List[str]:
        out: List[str] = []
        word = ""
        for ch in text.lower().strip():
            if ch.isspace() or ch in string.punctuation:
                if word:
                    out.append(word)
                    word = ""
                if not ch.isspace():
                    out.append(ch)
            else:
                word += ch
        if word:
            out.append(word)
        return out

    def _wordpiece(self, word: str) -> List[int]:
        ids: List[int] = []
        start = 0
        while start < len(word):
            for end in range(len(word), start, -1):
                piece = ("##" if start > 0 else "") + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    start = end
                    break
            else:
                return [self.unk_id]
        return ids

    def encode(self, text: str) -> List[int]:
        ids = [self.cls_id]
        for w in self._basic_tokenize(text):
            ids.extend(self._wordpiece(w))
        return ids[: self.max_len - 1] + [self.sep_id]

    def encode_batch(self, texts: Sequence[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T, max_len) int32 ids and bool attention mask, padded, on the CPU."""
        ids = torch.full((len(texts), self.max_len), self.pad_id, dtype=torch.int32)
        mask = torch.zeros((len(texts), self.max_len), dtype=torch.bool)
        for i, t in enumerate(texts):
            row = self.encode(t)
            ids[i, : len(row)] = torch.tensor(row, dtype=torch.int32)
            mask[i, : len(row)] = True
        return ids, mask


def toy_vocab(extra_words: Sequence[str] = ()) -> Dict[str, int]:
    """Tiny vocab for tests: specials + lowercase chars as continuations."""
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"]
    tokens += list(string.ascii_lowercase)
    tokens += ["##" + c for c in string.ascii_lowercase]
    tokens += list(extra_words)
    return {t: i for i, t in enumerate(tokens)}
