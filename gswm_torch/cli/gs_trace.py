"""Attribution CLI — who generated this image?  Port of
``gswm.cli.gs_trace``, flag for flag, plus ``--device`` (default ``cuda``;
``--device cpu`` for the CPU).

Inverts each image once, then ranks every registry record (info_data.jsonl
from gs-embed-torch and the other front ends, or a parsed reference
info_data.txt) by decode accuracy.  Where every record has one message
length the registry is packed once (``eval.trace.pack_candidates``) and
each image's latent is scored against it on the device
(``eval.trace.find_source_device``: one launch of the vote kernel for a
chunk of keys); a registry of mixed lengths takes the host loop
(``find_source``), which is what the reference runs.  The host side
(``gs_extract.load_images``, PIL) and the device side
(``attribute_arrays``) are two functions.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def build_parser():
    p = argparse.ArgumentParser(description="Attribute images to registry keys")
    p.add_argument("--registry", required=True,
                   help="info_data.jsonl or reference info_data.txt")
    p.add_argument("--images_directory_path", default="")
    p.add_argument("--single_image_path", default="")
    p.add_argument("--model_dir", default="")
    p.add_argument("--model_id", default="stabilityai/stable-diffusion-2-1-base")
    p.add_argument("--num_inference_steps", type=int, default=30)
    p.add_argument("--scheduler", default="DDIM", choices=["DDIM", "DPMs"])
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--message_length", type=int, default=256)
    p.add_argument("--l", type=int, default=1)
    p.add_argument("--min_accuracy", type=float, default=0.0,
                   help="report 'unattributed' below this accuracy")
    p.add_argument("--out_jsonl", default="attributions.jsonl")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipeline and the search (cpu for the CPU)")
    return p


def load_registry(path: str) -> list[dict]:
    if path.endswith(".jsonl"):
        from gswm_torch.utils.io import load_jsonlines

        return load_jsonlines(path)
    from gswm_torch.eval.registry import parse_info_data_txt

    recs = parse_info_data_txt(path)
    return [
        {"key_hex": r["key"], "nonce_hex": r["nonce"],
         "message_hex": r["message"],
         "message_length": int(r.get("message_length") or 0) or None}
        for r in recs if "key" in r
    ]


def attribute_arrays(pipe, records, args, images) -> list[tuple[int, float]]:
    """(B, 3, H, W) images in [0, 1] -> [(best record index, its accuracy)]
    per image: one inversion of the batch on the pipeline's device, then
    each recovered latent scored against every record."""
    from gswm_torch.eval import trace

    z = pipe.invert(images=images, num_steps=args.num_inference_steps,
                    scheduler=args.scheduler)
    lengths = {trace._message_bits(r, args.message_length) for r in records}
    packed = trace.pack_candidates(records, args.message_length, device=pipe.device) \
        if len(lengths) == 1 else None
    out = []
    for row in z:
        if packed is not None:
            best, acc, _ = trace.find_source_device(row, packed, l=args.l,
                                                    device=pipe.device)
        else:
            best, acc, _ = trace.find_source(row, records, message_bits=args.message_length,
                                             l=args.l)
        out.append((best, acc))
    return out


def main(argv=None):
    args = build_parser().parse_args(argv)
    records = load_registry(args.registry)
    if not records:
        raise SystemExit(f"no records in {args.registry}")

    from gswm_torch.cli.gs_extract import load_images, make_pipeline

    pipe = make_pipeline(args)

    if args.single_image_path:
        paths = [args.single_image_path]
    else:
        paths = sorted(
            glob.glob(os.path.join(args.images_directory_path, "*.png"))
            + glob.glob(os.path.join(args.images_directory_path, "*.jpg"))
        )

    with open(args.out_jsonl, "a") as out:
        for path in paths:
            imgs = load_images([path], (args.width, args.height))
            (best, acc), = attribute_arrays(pipe, records, args, imgs)
            rec = records[best] if acc >= args.min_accuracy else None
            line = {
                "image": os.path.basename(path),
                "best_index": best if rec else None,
                "accuracy": acc,
                "key_hex": rec["key_hex"] if rec else None,
                "message_hex": rec["message_hex"] if rec else None,
            }
            out.write(json.dumps(line) + "\n")
            print(f"{line['image']}: "
                  + (f"record {best} acc {acc:.4f}" if rec else
                     f"unattributed (best acc {acc:.4f})"))


if __name__ == "__main__":
    main()
