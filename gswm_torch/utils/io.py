"""jsonl/json IO helpers: the port's copy of ``gswm.utils.io`` (host only;
API parity with the reference's compiled-only io_utils module, SURVEY.md
§2.3: resolve_globs, read_jsonlines, load_jsonlines, write_jsonlines,
read_json, write_json, print_json)."""

from __future__ import annotations

import glob as _glob
import json
from typing import Iterable, Iterator


def resolve_globs(patterns: str | Iterable[str]) -> list[str]:
    if isinstance(patterns, str):
        patterns = [patterns]
    out: list[str] = []
    for p in patterns:
        out.extend(sorted(_glob.glob(p)))
    return out


def read_jsonlines(path: str) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def load_jsonlines(path: str) -> list[dict]:
    return list(read_jsonlines(path))


def write_jsonlines(records: Iterable[dict], path: str, mode: str = "w"):
    with open(path, mode) as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def write_json(obj, path: str, indent: int = 2):
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent)


def print_json(obj):
    print(json.dumps(obj, indent=2))
