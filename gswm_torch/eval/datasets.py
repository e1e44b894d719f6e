"""Prompt datasets for evaluation — optim_utils.get_dataset parity
(SURVEY.md §2.3: laion/coco prompt sets).

Offline-first: loads prompts from local jsonl/json/txt files; ships a small
built-in prompt list so quality sweeps run with zero assets.

The port's copy of ``gswm.eval.datasets`` (host only).
"""

from __future__ import annotations

import os

from gswm_torch.utils.io import load_jsonlines, read_json

# A neutral built-in set for smoke evals (not from any external dataset).
BUILTIN_PROMPTS = [
    "a photograph of an astronaut riding a horse",
    "a watercolor painting of a lighthouse at dawn",
    "an isometric illustration of a tiny city block",
    "a macro photo of dew drops on a spider web",
    "a cozy reading nook with warm lamplight",
    "a bowl of ramen with steam rising, studio lighting",
    "a red vintage bicycle leaning against a brick wall",
    "snow-capped mountains reflected in a still lake",
    "a robot tending a rooftop vegetable garden",
    "a calico cat sleeping on a stack of books",
]


def get_dataset(source: str | None = None, prompt_key: str = "Prompt",
                limit: int | None = None) -> list[str]:
    """Load prompts.

    source: None -> BUILTIN_PROMPTS; *.jsonl -> records[prompt_key] (the
    reference's laion/coco jsonl layout); *.json -> list or {key: [...]};
    *.txt -> one prompt per line.
    """
    if source is None:
        prompts = list(BUILTIN_PROMPTS)
    elif source.endswith(".jsonl"):
        prompts = [r[prompt_key] for r in load_jsonlines(source)]
    elif source.endswith(".json"):
        data = read_json(source)
        prompts = data if isinstance(data, list) else data[prompt_key]
    elif source.endswith(".txt"):
        with open(source) as f:
            prompts = [line.strip() for line in f if line.strip()]
    elif os.path.isdir(source):
        raise ValueError("pass a file, not a directory")
    else:
        raise ValueError(f"unsupported prompt source {source!r}")
    return prompts[:limit] if limit else prompts
