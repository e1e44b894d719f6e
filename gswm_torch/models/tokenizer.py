"""CLIP's byte-level BPE tokenizer, written by hand: prompt text -> the 77
token ids the text encoders take, with no ``transformers``, ``regex`` or
``ftfy`` (the machine with the card has none of them).

It reads ``vocab.json`` and ``merges.txt`` (a CLIP checkpoint's tokenizer
files) and gives the ids of transformers' ``CLIPTokenizer(...,
padding="max_length", max_length=77, truncation=True)`` where ftfy is not
installed, which is the case to match: that tokenizer then cleans text with
its ``BasicTokenizer(strip_accents=False, do_split_on_punc=False)`` instead
of ``ftfy.fix_text``:

  * control characters, NUL and U+FFFD dropped, whitespace made a space;
    every CJK ideograph set apart by spaces; NFC normalisation; split on
    whitespace, each word lowercased, the words joined by single spaces;
  * CLIP's pre-tokenizer pattern, ``<|startoftext|>|<|endoftext|>|'s|'t|
    're|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (case-blind),
    with the stdlib ``re``: letters are ``[^\\W\\d_]`` (word characters but
    digits and the underscore), the rest of a run ``(?:[^\\s\\w]|_)+``;
    ``[^\\W\\d_]`` also holds the numerals of Unicode categories No and Nl
    ("²", "½", "Ⅻ"), which ``\\p{N}`` makes one token each, so a letter run
    is split at those here;
  * each piece's UTF-8 bytes mapped through ``bytes_to_unicode``, the last
    symbol marked ``</w>``, and merged by rank;
  * ``<|startoftext|>`` + at most 75 ids + ``<|endoftext|>``, padded with
    the pad token to 77; a token not in the vocabulary takes the unknown
    token's id.

The special tokens (bos, eos, unk, pad) are CLIPTokenizer's defaults
(``<|startoftext|>``, then ``<|endoftext|>`` for the other three) unless the
checkpoint's ``tokenizer_config.json`` or ``special_tokens_map.json`` name
others, the second overriding the first, as ``from_pretrained`` reads them:
SD 2.x pads with ``!`` (id 0).  As there, the text is first split at every
special token, each one its own id, and the rest is cleaned and encoded
piece by piece.
"""

from __future__ import annotations

import functools
import json
import os
import re
import unicodedata
from typing import Optional

import numpy as np

BOS = "<|startoftext|>"
EOS = "<|endoftext|>"
# CLIPTokenizer's special tokens and defaults, in the order it adds them
SPECIALS = {"bos_token": BOS, "eos_token": EOS, "unk_token": EOS, "pad_token": EOS}
SPECIAL_FILES = ("tokenizer_config.json", "special_tokens_map.json")
MAX_LENGTH = 77
# CLIPTokenizer reads the merges after the version line, at most this many
MAX_MERGES = 49152 - 256 - 2

_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|(?P<letters>[^\W\d_]+)|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE)


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> dict[int, str]:
    """CLIP's (and GPT-2's) byte -> printable character table: the bytes
    that print as themselves keep their character, the other 68 take
    U+0100 onwards in byte order."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> str:
    """transformers' BasicTokenizer(strip_accents=False,
    do_split_on_punc=False).tokenize, joined by single spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch).startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    words = unicodedata.normalize("NFC", "".join(out)).split()
    return " ".join(w.lower() for w in words)


def pre_tokenize(text: str) -> list[str]:
    """CLIP's pattern over cleaned text (see the module docstring)."""
    pieces = []
    for m in _PATTERN.finditer(text):
        run = m.group("letters")
        if run is None:
            pieces.append(m.group())
            continue
        # [^\W\d_] holds the numerals of No / Nl, which \p{N} makes one
        # token each
        word = ""
        for ch in run:
            if unicodedata.category(ch)[0] == "N":
                if word:
                    pieces.append(word)
                    word = ""
                pieces.append(ch)
            else:
                word += ch
        if word:
            pieces.append(word)
    return pieces


class CLIPTokenizer:
    """Byte-level BPE over a CLIP ``vocab.json`` and ``merges.txt``;
    ``specials`` overrides entries of ``SPECIALS``."""

    def __init__(self, vocab_file: str, merges_file: str,
                 specials: Optional[dict] = None):
        with open(vocab_file, encoding="utf-8") as f:
            self.encoder: dict[str, int] = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:MAX_MERGES + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.cache = {BOS: BOS, EOS: EOS}
        tokens = {**SPECIALS, **(specials or {})}
        for token in tokens.values():  # one missing from the vocabulary is added
            self.encoder.setdefault(token, len(self.encoder))
        self.bos_token_id = self.encoder[tokens["bos_token"]]
        self.eos_token_id = self.encoder[tokens["eos_token"]]
        self.unk_token_id = self.encoder[tokens["unk_token"]]
        self.pad_token_id = self.encoder[tokens["pad_token"]]
        # the text is split at the special tokens first, the longest first
        self.special_split = re.compile("(" + "|".join(
            re.escape(t) for t in sorted(set(tokens.values()), key=len, reverse=True)) + ")")

    def bpe(self, token: str) -> str:
        """One pre-tokenized piece (byte characters) -> its BPE symbols,
        space-separated, the last one ending in ``</w>``."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> list[str]:
        """Text -> BPE tokens (no special tokens added): the special tokens
        in the text stand as they are, the chunks between them are cleaned
        and encoded."""
        tokens = []
        for i, chunk in enumerate(self.special_split.split(text)):
            if i % 2:
                tokens.append(chunk)
                continue
            for piece in pre_tokenize(basic_clean(chunk)):
                mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
                tokens.extend(self.bpe(mapped).split(" "))
        return tokens

    def encode(self, text: str) -> list[int]:
        """Text -> token ids, no special tokens, not truncated."""
        return [self.encoder.get(t, self.unk_token_id) for t in self.tokenize(text)]

    def __call__(self, texts, max_length: int = MAX_LENGTH) -> np.ndarray:
        """A prompt or a list of prompts -> (B, max_length) int64 input ids:
        BOS, at most ``max_length`` - 2 ids, EOS, then the pad token."""
        if isinstance(texts, str):
            texts = [texts]
        ids = np.full((len(texts), max_length), self.pad_token_id, dtype=np.int64)
        for row, text in enumerate(texts):
            body = self.encode(text)[:max_length - 2]
            seq = [self.bos_token_id] + body + [self.eos_token_id]
            ids[row, :len(seq)] = seq
        return ids


def read_specials(model_dir: str) -> dict:
    """The special tokens that ``SPECIAL_FILES`` in ``model_dir`` name (a
    string, or an object whose ``content`` is one), the later file winning."""
    specials = {}
    for name in SPECIAL_FILES:
        path = os.path.join(model_dir, name)
        if not os.path.exists(path):
            continue
        with open(path, encoding="utf-8") as f:
            entries = json.load(f)
        for key in SPECIALS:
            value = entries.get(key)
            if isinstance(value, dict):
                value = value.get("content")
            if value:
                specials[key] = value
    return specials


def load_tokenizer(model_dir: str) -> CLIPTokenizer:
    """The tokenizer of a local checkpoint directory holding ``vocab.json``
    and ``merges.txt`` (and, where it has them, ``SPECIAL_FILES``): the port
    of ``gswm.models.text.load_tokenizer``."""
    return CLIPTokenizer(os.path.join(model_dir, "vocab.json"),
                         os.path.join(model_dir, "merges.txt"),
                         read_specials(model_dir))
