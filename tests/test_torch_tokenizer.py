"""The port's hand-written CLIP BPE (``gswm_torch.models.tokenizer``) against
transformers' ``CLIPTokenizer`` (without ftfy, its BasicTokenizer cleanup),
padded and truncated to 77 ids.

Two vocabularies, both from CLIP's byte-to-unicode table: the one
tests/test_prompt_tokenizer.py synthesizes (every byte character, with and
without ``</w>``, one real merge chain), and a larger one whose merges are
learnt here from an English and non-English corpus by the BPE rule itself
(the most frequent pair first), so that long merge chains, word ends and
multi-byte characters are exercised.  The ids must be equal on every prompt.
"""

import collections
import json

import numpy as np
import pytest
from transformers import CLIPTokenizer
from transformers.models.clip.tokenization_clip import bytes_to_unicode

from gswm_torch.models import tokenizer

CORPUS = ("a photograph of an astronaut riding a horse on the moon, highly detailed "
          "painting of a cat sitting on the mat in the garden at sunset; oil on canvas "
          "portrait of a woman with a pearl earring it's don't we'll they're i've "
          "café crème brûlée naïve façade über straße señor niño ñandú "
          "привет мир москва 你好世界 東京 ελληνικά 123 4567 x² ½")
PROMPTS = [
    "a cat",
    "A photograph of an astronaut riding a horse!!",
    "",
    "   ",
    "it's 2024, don't   panic\t\n",
    "highly-detailed oil_painting (masterpiece:1.2) [sunset] {garden}",
    "café Crème BRÛLÉE naïve façade",
    "Über Straße señor NIÑO ñandú",
    "Привет мир, МОСКВА",
    "你好世界 東京 tokyo",
    "ελληνικά αλφάβητο",
    "x²+½ Ⅻ u_v __init__ 3.14159",
    "emoji 🚀🎨 ok",
    "ideographic　space and é combining",
    "a\x00b​c\x7fd",
    "word " * 100,
    "the quick brown fox jumps over the lazy dog " * 8,
    "wow ! yes a!b <pad>x<|endoftext|>y",  # special tokens inside the text
]


def write_vocab(directory, merges=(), words=(), pad_token=None):
    """vocab.json + merges.txt in ``directory``: every byte character, with
    and without ``</w>``, the merges' products, ``words`` and the specials.
    ``pad_token``: also the special-token files of an SD 2.x tokenizer,
    whose special_tokens_map.json sets that pad token over
    tokenizer_config.json's."""
    directory.mkdir(parents=True, exist_ok=True)
    chars = list(bytes_to_unicode().values())
    vocab = {}
    for token in chars + [c + "</w>" for c in chars] + [a + b for a, b in merges] + list(words):
        vocab.setdefault(token, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (directory / "vocab.json").write_text(json.dumps(vocab))
    (directory / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    if pad_token is not None:
        def added(content):
            return {"content": content, "lstrip": False, "normalized": True,
                    "rstrip": False, "single_word": False}

        (directory / "tokenizer_config.json").write_text(json.dumps({
            "bos_token": {"__type": "AddedToken", **added("<|startoftext|>")},
            "eos_token": {"__type": "AddedToken", **added("<|endoftext|>")},
            "unk_token": {"__type": "AddedToken", **added("<|endoftext|>")},
            "pad_token": "<|endoftext|>", "model_max_length": 77,
            "tokenizer_class": "CLIPTokenizer"}))
        (directory / "special_tokens_map.json").write_text(json.dumps({
            "bos_token": added("<|startoftext|>"), "eos_token": added("<|endoftext|>"),
            "unk_token": added("<|endoftext|>"), "pad_token": pad_token}))
    return str(directory)


def learn_merges(corpus: str, n: int) -> list[tuple[str, str]]:
    """``n`` merges by the BPE rule on the byte-mapped words of ``corpus``."""
    b2u = bytes_to_unicode()
    words = collections.Counter()
    for word in tokenizer.pre_tokenize(tokenizer.basic_clean(corpus)):
        mapped = "".join(b2u[b] for b in word.encode("utf-8"))
        words[tuple(mapped[:-1]) + (mapped[-1] + "</w>",)] += 1
    merges = []
    for _ in range(n):
        pairs = collections.Counter()
        for word, count in words.items():
            for pair in zip(word, word[1:]):
                pairs[pair] += count
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged = collections.Counter()
        for word, count in words.items():
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            merged[tuple(out)] += count
        words = merged
    return merges


@pytest.fixture(scope="module", params=["synthesized", "learnt", "sd2-pad", "added-pad"])
def vocab_dir(request, tmp_path_factory):
    """The two vocabularies; the learnt one also with SD 2.x's special-token
    files (pad "!", id 0, which the text is split at too) and with a pad
    token the vocabulary lacks (added after it)."""
    d = tmp_path_factory.mktemp(request.param)
    if request.param == "synthesized":  # tests/test_prompt_tokenizer.py's
        return write_vocab(d, merges=[("c", "a"), ("ca", "t</w>")], words=("cat</w>",))
    pad = {"learnt": None, "sd2-pad": "!", "added-pad": "<pad>"}[request.param]
    return write_vocab(d, merges=learn_merges(CORPUS, 400), pad_token=pad)


@pytest.mark.parametrize("prompt", PROMPTS, ids=range(len(PROMPTS)))
def test_ids_equal_clip_tokenizer(vocab_dir, prompt):
    want = CLIPTokenizer.from_pretrained(vocab_dir, local_files_only=True)(
        prompt, padding="max_length", max_length=77, truncation=True)["input_ids"]
    got = tokenizer.load_tokenizer(vocab_dir)(prompt)
    assert got.shape == (1, 77) and got.dtype == np.int64
    assert got[0].tolist() == want


def test_batch_of_prompts_and_tokens(vocab_dir):
    hf = CLIPTokenizer.from_pretrained(vocab_dir, local_files_only=True)
    tok = tokenizer.load_tokenizer(vocab_dir)
    want = hf(PROMPTS, padding="max_length", max_length=77, truncation=True,
              return_tensors="np").input_ids
    np.testing.assert_array_equal(tok(PROMPTS), want)
    for prompt in PROMPTS[:12]:
        assert tok.tokenize(prompt) == hf.tokenize(prompt)
    assert (tok.bos_token_id, tok.eos_token_id, tok.pad_token_id) == (
        hf.bos_token_id, hf.eos_token_id, hf.pad_token_id)


def test_learnt_merges_fire(tmp_path):
    """The larger vocabulary merges whole words: fewer ids than bytes."""
    d = write_vocab(tmp_path, merges=learn_merges(CORPUS, 400))
    tok = tokenizer.load_tokenizer(d)
    ids = tok.encode("a photograph of an astronaut riding a horse")
    assert len(ids) < len("a photograph of an astronaut riding a horse") // 2
    assert tokenizer.bytes_to_unicode() == bytes_to_unicode()


def test_sd2_special_tokens_file_sets_the_pad(tmp_path):
    """SD 2.x's special_tokens_map.json pads with "!" (id 0), and "!" in a
    prompt is that special token, not the BPE of "!</w>"."""
    tok = tokenizer.load_tokenizer(write_vocab(tmp_path, pad_token="!"))
    assert tok.pad_token_id == 0 and tok.unk_token_id == tok.eos_token_id
    ids = tok("a")[0].tolist()
    assert ids[:3] == [tok.bos_token_id, tok.encoder["a</w>"], tok.eos_token_id]
    assert ids[3:] == [0] * 74
    assert tok.tokenize("horse!!")[-2:] == ["!", "!"]
