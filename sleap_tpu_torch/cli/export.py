"""``sleap-export``: export trained models as ``torch.export`` programs.

Port of :mod:`sleap_tpu.cli.export`, with its flags, plus ``--cpu``: the
program is exported on the card unless ``--cpu`` asks for the CPU, and it
runs where it was exported (:mod:`sleap_tpu_torch.inference.export`).

    python -m sleap_tpu_torch.cli.export -m <folder> [-m <folder>] -e <out> [--cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from sleap_tpu_torch.precision import disable_tf32


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Export a sleap-tpu model (PyTorch port).")
    parser.add_argument(
        "-m", "--model", action="append", dest="models", required=True,
        help="Model run folder (repeatable).",
    )
    parser.add_argument("-e", "--export_path", default="exported_model")
    parser.add_argument("-n", "--max_instances", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--image_size", type=int, default=None)
    parser.add_argument("--cpu", action="store_true", help="Export for the CPU instead of the card.")
    return parser


def main(args: Optional[List[str]] = None) -> None:
    ns = make_parser().parse_args(args)
    disable_tf32()

    from sleap_tpu_torch.inference.export import export_model

    out = export_model(
        ns.models if len(ns.models) > 1 else ns.models[0],
        save_path=ns.export_path,
        batch_size=ns.batch_size,
        image_size=ns.image_size,
        max_instances=ns.max_instances,
        device="cpu" if ns.cpu else "cuda",
    )
    print(f"Exported to: {out}")


if __name__ == "__main__":
    main()
