"""Shared utilities of the PyTorch port: jsonl/json IO (``gswm.utils.io``)."""

from gswm_torch.utils.io import (  # noqa: F401
    load_jsonlines,
    print_json,
    read_json,
    read_jsonlines,
    resolve_globs,
    write_json,
    write_jsonlines,
)
