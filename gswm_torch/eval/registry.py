"""Key/metadata persistence (the port's copy of ``gswm.eval.registry``, host
only) — the reference's "observability" layer
(SURVEY.md §1 L5): an ``info_data.txt`` append-log of key/nonce/message per
generation (gs_insert.py:68-74, nodes.py:125-136), kept byte-compatible, plus
a structured jsonl mirror for machine consumption and multi-key traceability
at 10k-image scale (BASELINE config 5)."""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Optional


class KeyRegistry:
    def __init__(self, directory: str = ".", jsonl: bool = True):
        self.txt_path = os.path.join(directory, "info_data.txt")
        self.jsonl_path = os.path.join(directory, "info_data.jsonl") if jsonl else None

    def record(
        self,
        key: bytes,
        nonce: bytes,
        message: bytes,
        seed: Optional[int] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        message_length: Optional[int] = None,
        image_id: Optional[str] = None,
    ):
        now = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        with open(self.txt_path, "a") as f:
            f.write(f"Time: {now}\n")
            f.write(f"key: {key.hex()}\n")
            f.write(f"nonce: {nonce.hex()}\n")
            f.write(f"message: {message.hex()}\n")
            if seed is not None:
                # the reference's resolution-adaptive core logs these extras
                # (nodes.py:125-136, duplicate randomSeed line included there;
                # we log each once)
                f.write(f"randomSeed: {seed}\n")
            if height is not None:
                f.write(f"height: {height}\n")
            if width is not None:
                f.write(f"width: {width}\n")
            if message_length is not None:
                f.write(f"message_length: {message_length}\n")
            f.write("----------------------\n")
        if self.jsonl_path:
            rec = {
                "time": now,
                "key_hex": key.hex(),
                "nonce_hex": nonce.hex(),
                "message_hex": message.hex(),
                "seed": seed,
                "height": height,
                "width": width,
                "message_length": message_length,
                "image_id": image_id,
            }
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def load_jsonl(self) -> list[dict]:
        if not self.jsonl_path or not os.path.exists(self.jsonl_path):
            return []
        with open(self.jsonl_path) as f:
            return [json.loads(line) for line in f if line.strip()]


def parse_info_data_txt(path: str) -> list[dict]:
    """Parse a reference-produced info_data.txt into records (cross-tool
    compatibility: extract with keys logged by the reference UIs)."""
    records, cur = [], {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("---"):
                if cur:
                    records.append(cur)
                cur = {}
            elif ": " in line:
                k, v = line.split(": ", 1)
                cur[k.strip().lower()] = v.strip()
    if cur:
        records.append(cur)
    return records
