"""CLIP byte-level BPE tokenizer of the port (a copy of sdtpu/tokenizer.py).

- byte <-> printable unicode table;
- merges from `bpe_simple_vocab_16e6.txt` rows [1, 48895): a file of that
  name in the working directory first, as the reference CLI reads it, else
  the gzipped copy in `sdtpu_torch/data/`;
- vocab = 256 chars + 256 chars+"</w>" + 48894 merges + 2 specials = 49408;
- lowercase and whitespace-clean on encode, greedy lowest-rank merges;
- no padding or truncation to 77 tokens (the pipeline does that);
- ASCII text through the native runtime's fast path (sdtpu_torch.runtime)
  where it is built, as sdtpu's; other text, or a host without the
  runtime, through the Python encoder, which is its oracle.

tests/test_torch_config.py holds its ids equal to sdtpu's.
"""

from __future__ import annotations

import gzip
import os
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import regex as re

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|\p{L}+|\p{N}|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
SOT_ID = 49406
EOT_ID = 49407


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Map every byte to a printable unicode char."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _default_vocab_path() -> str:
    """The merges file: bpe_simple_vocab_16e6.txt in the working directory
    if there is one, else the gzipped copy bundled with the package."""
    cwd_path = os.path.join(os.getcwd(), "bpe_simple_vocab_16e6.txt")
    if os.path.exists(cwd_path):
        return cwd_path
    return os.path.join(os.path.dirname(__file__), "data", "bpe_simple_vocab_16e6.txt.gz")


def _read_merge_lines(path: str) -> List[str]:
    if path.endswith(".gz"):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            return f.read().split("\n")
    with open(path, "r", encoding="utf-8") as f:
        return f.read().split("\n")


def get_pairs(word: Sequence[str]) -> set:
    return set(zip(word[:-1], word[1:]))


def whitespace_clean(text: str) -> str:
    return " ".join(text.split())


def _read_merges_bytes(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


class SimpleTokenizer:
    """CLIP BPE encoder/decoder. use_native: ASCII text through the native
    runtime where it is built (module docstring)."""

    def __init__(self, vocab_path: str | None = None, use_native: bool = True):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        path = vocab_path or _default_vocab_path()
        self._native = None
        if use_native:
            from sdtpu_torch import runtime

            if runtime.available():
                self._native = runtime.NativeTokenizer(_read_merges_bytes(path))

        lines = _read_merge_lines(path)
        # rows [1, 49152-256-2+1) = [1, 48895)
        merge_lines = lines[1 : 49152 - 256 - 2 + 1]
        merges: List[Tuple[str, str]] = []
        for line in merge_lines:
            parts = line.split()
            if len(parts) >= 2:
                merges.append((parts[0], parts[1]))

        chars = list(self.byte_encoder.values())
        vocab: List[str] = chars + [c + "</w>" for c in chars]
        vocab.extend(a + b for a, b in merges)
        vocab.extend([SOT, EOT])

        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {SOT: SOT, EOT: EOT}

    @property
    def n_vocab(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        cached = self.cache.get(token)
        if cached is not None:
            return cached
        word: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = new_word
            if len(word) == 1:
                break
            pairs = get_pairs(word)

        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        if self._native is not None:
            ids = self._native.encode(text)
            if ids is not None:
                return ids
        text = whitespace_clean(text.strip()).lower()
        bpe_tokens: List[int] = []
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        data = bytes(self.byte_decoder[c] for c in text)
        return data.decode("utf-8", errors="replace").replace("</w>", " ")

    def encode_prompt(self, prompt: str) -> List[int]:
        """Wrap with SOT/EOT as the pipeline does; not padded to 77."""
        return self.encode(f"{SOT}{prompt}{EOT}")
