"""
Self-contained CLIP BPE tokenizer: the port's own copy of
riffusion_tpu/models/tokenizer.py (the same ids for the same text, held to
it by tests/test_torch_host.py).

Loads `vocab.json` + `merges.txt` from a local checkpoint's `tokenizer/`
directory (the diffusers layout). When no vocab files exist (e.g.
random-weight test/benchmark models) a deterministic hash tokenizer stands
in so the full pipeline stays runnable offline.

The BPE algorithm, byte<->unicode table, and token pattern follow the
published CLIP tokenizer specification (Radford et al. 2021, openai/CLIP);
implementation is original.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
import typing as T

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"


@functools.lru_cache()
def _bytes_to_unicode() -> T.Dict[int, str]:
    """Reversible mapping from bytes to printable unicode chars (GPT-2/CLIP)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """BPE tokenizer with the transformers-compatible call surface the
    pipeline needs: `__call__` with max_length padding/truncation, plus raw
    `encode` for the weighted-prompt path."""

    def __init__(self, vocab: T.Dict[str, int], merges: T.List[T.Tuple[str, str]],
                 model_max_length: int = 77):
        self.encoder = vocab
        self.decoder = {v: k for k, v in vocab.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.model_max_length = model_max_length
        self.bos_token_id = vocab.get(BOS, 0)
        self.eos_token_id = vocab.get(EOS, 1)
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
            if False
            else r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE,
        )
        self._bpe_cache: T.Dict[str, str] = {}

    # ------------------------------------------------------------ constructors

    @classmethod
    def from_pretrained(cls, path: str, model_max_length: int = 77) -> "CLIPTokenizer":
        """Load from a directory containing vocab.json + merges.txt, a
        checkpoint root with a tokenizer/ subfolder, or a bpe .txt(.gz)."""
        for cand in (path, os.path.join(path, "tokenizer")):
            vocab_path = os.path.join(cand, "vocab.json")
            merges_path = os.path.join(cand, "merges.txt")
            if os.path.exists(vocab_path) and os.path.exists(merges_path):
                with open(vocab_path, encoding="utf-8") as fh:
                    vocab = json.load(fh)
                with open(merges_path, encoding="utf-8") as fh:
                    lines = fh.read().split("\n")
                merges = [
                    tuple(line.split()) for line in lines
                    if line and not line.startswith("#version") and len(line.split()) == 2
                ]
                return cls(vocab, merges, model_max_length)
        # openai-style bpe file
        if os.path.isfile(path) and path.endswith((".txt", ".txt.gz")):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt", encoding="utf-8") as fh:
                lines = fh.read().split("\n")
            merge_lines = lines[1 : 49152 - 256 - 2 + 1]
            merges = [tuple(line.split()) for line in merge_lines]
            chars = list(_bytes_to_unicode().values())
            tokens = chars + [c + "</w>" for c in chars]
            tokens += ["".join(m) for m in merges]
            tokens += [BOS, EOS]
            vocab = {t: i for i, t in enumerate(tokens)}
            return cls(vocab, merges, model_max_length)
        raise FileNotFoundError(f"No tokenizer files found under {path}")

    # --------------------------------------------------------------------- bpe

    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: T.List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        result = " ".join(word)
        self._bpe_cache[token] = result
        return result

    def encode(self, text: str) -> T.List[int]:
        """Text -> BPE token ids (no special tokens, no padding)."""
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids: T.List[int] = []
        for token in re.findall(self.pat, text):
            if token in (BOS, EOS):
                ids.append(self.encoder[token])
                continue
            token_bytes = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            for piece in self._bpe(token_bytes).split(" "):
                ids.append(self.encoder.get(piece, self.eos_token_id))
        return ids

    def __call__(
        self,
        text: T.Union[str, T.List[str]],
        padding: str = "max_length",
        max_length: T.Optional[int] = None,
        truncation: bool = True,
        **_: T.Any,
    ) -> T.Dict[str, T.List[T.List[int]]]:
        """transformers-style batch encode: BOS + ids + EOS, padded with EOS."""
        texts = [text] if isinstance(text, str) else list(text)
        max_length = max_length or self.model_max_length
        batch = []
        for t in texts:
            ids = self.encode(t)
            if truncation:
                ids = ids[: max_length - 2]
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
            if padding == "max_length" and len(ids) < max_length:
                ids = ids + [self.eos_token_id] * (max_length - len(ids))
            batch.append(ids)
        return {"input_ids": batch}


class HashTokenizer:
    """Deterministic stand-in tokenizer for random-weight models: stable
    FNV-1a word hashing into a small vocab. Same call surface as
    CLIPTokenizer so the pipeline code doesn't branch."""

    def __init__(self, vocab_size: int = 1024, model_max_length: int = 77):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.bos_token_id = 0
        self.eos_token_id = 1

    def encode(self, text: str) -> T.List[int]:
        ids = []
        for word in _whitespace_clean(text).lower().split(" "):
            if not word:
                continue
            h = 2166136261
            for ch in word.encode("utf-8"):
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids.append(2 + (h % (self.vocab_size - 2)))
        return ids

    def __call__(
        self,
        text: T.Union[str, T.List[str]],
        padding: str = "max_length",
        max_length: T.Optional[int] = None,
        truncation: bool = True,
        **_: T.Any,
    ) -> T.Dict[str, T.List[T.List[int]]]:
        texts = [text] if isinstance(text, str) else list(text)
        max_length = max_length or self.model_max_length
        batch = []
        for t in texts:
            ids = self.encode(t)
            if truncation:
                ids = ids[: max_length - 2]
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
            if padding == "max_length" and len(ids) < max_length:
                ids = ids + [self.eos_token_id] * (max_length - len(ids))
            batch.append(ids)
        return {"input_ids": batch}
