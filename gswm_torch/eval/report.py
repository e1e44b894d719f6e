"""Batch-extraction reports: byte-compatible ``result.txt`` writers
(extract.py:141-175) plus a jsonl mirror that enables resume-by-skip
(SURVEY.md §5 "Checkpoint / resume").

The port's copy of ``gswm.eval.report`` (host only)."""

from __future__ import annotations

import json
import os
from datetime import datetime


def write_batch_info(result_file, args):
    """Header block, field-for-field with extract.py:166-175."""
    result_file.write("=" * 40 + "Batch Info" + "=" * 40 + "\n")
    now = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    result_file.write(f"Time,{now}\n")
    result_file.write(f"key_hex,{args.key_hex}\n")
    result_file.write(f"nonce_hex,{args.nonce_hex}\n")
    result_file.write(f"original_message_hex,{args.original_message_hex}\n")
    result_file.write(f"num_inference_steps,{args.num_inference_steps}\n")
    result_file.write(f"scheduler,{args.scheduler}\n")
    result_file.write("=" * 40 + "Batch Start" + "=" * 40 + "\n")


class BatchReport:
    """Per-directory report: result.txt (reference format) + results.jsonl."""

    def __init__(self, directory: str, args):
        self.directory = directory
        self.args = args
        self.txt_path = os.path.join(directory, "result.txt")
        self.jsonl_path = os.path.join(directory, "results.jsonl")
        self.total = 0.0
        self.count = 0
        self._txt = open(self.txt_path, "a")
        write_batch_info(self._txt, args)

    def already_done(self) -> set[str]:
        """Image names recorded in results.jsonl (resume-by-skip)."""
        done = set()
        if os.path.exists(self.jsonl_path):
            with open(self.jsonl_path) as f:
                for line in f:
                    # a line torn by an interrupted run is skipped: its
                    # image is extracted again
                    try:
                        done.add(json.loads(line)["image"])
                    except (json.JSONDecodeError, KeyError):
                        pass
        return done

    def record(self, image_path: str, bit_accuracy: float, extracted_bin: str = ""):
        name = os.path.basename(image_path)
        self._txt.write(f"{name}, Bit Accuracy, {bit_accuracy}\n")
        self._txt.flush()
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({
                "image": name,
                "bit_accuracy": bit_accuracy,
                "extracted_bin": extracted_bin,
            }) + "\n")
        self.total += float(bit_accuracy)
        self.count += 1

    def record_error(self, image_path: str, err: Exception):
        # per-item isolation: log and continue (extract.py:153-155)
        self._txt.write(f"Error processing {image_path}: {err}\n")
        self._txt.flush()

    def close(self) -> float | None:
        avg = None
        if self.count > 0:
            avg = self.total / self.count
            self._txt.write(f"Average Bit Accuracy, {avg}\n\n")
            self._txt.write("=" * 40 + "Batch End" + "=" * 40 + "\n")
            parent = os.path.dirname(self.directory.rstrip("/"))
            if parent and os.path.isdir(parent):
                with open(os.path.join(parent, "result.txt"), "a") as pf:
                    pf.write(
                        f"{os.path.basename(self.directory.rstrip('/'))}, "
                        f"Average Bit Accuracy, {avg}\n"
                    )
        self._txt.close()
        return avg
