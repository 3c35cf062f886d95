"""``sleap-convert`` on the port: convert labels between formats.

    python -m sleap_tpu_torch.io.convert labels.slp --format analysis [-o out.h5 ...] [--video PART]

:mod:`sleap_tpu.io.convert` on the port's readers and writers. The input is
any format :func:`sleap_tpu_torch.io.formats.read` reads (``--input_format``
or sniffed). ``--format`` ``slp``, ``h5`` and ``json`` write a ``.slp``
(``<input>.<format>``, or the first ``-o``), ``pkg.slp`` one with the
labeled frames embedded; ``analysis`` and ``analysis.csv`` write each
video's analysis file (``-o`` once a video, else
:func:`default_analysis_filename`; ``--video`` keeps the first video whose
path holds it; a video without labeled frames is reported and skipped).
``nwb`` writes ``<input>.nwb`` through ``pynwb`` and ``ndx_pose``, ``nix``
and ``analysis.nix`` nixtrack files through ``nixio``; where those packages
are absent they raise ``ImportError`` naming them. Videos decode on ``device`` (the card by default; a Python
caller may pass ``device="cpu"``).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional


def default_analysis_filename(labels, video, output_path: str, output_prefix: str,
                              format_suffix: str = "h5") -> str:
    """``<output_path>/<prefix>.<video index:03>_<video stem>.analysis.<suffix>``."""
    video_idx = labels.videos.index(video)
    stem = os.path.splitext(os.path.basename(video.backend.filename))[0]
    return os.path.join(output_path, f"{output_prefix}.{video_idx:03}_{stem}.analysis.{format_suffix}")


def convert(input_path: str, output_path: Optional[str] = None, input_format: str = "",
            output_format: str = "slp", device="cuda") -> str:
    """Convert one file; returns the path written."""
    from sleap_tpu_torch.io import formats

    labels = formats.read(input_path, as_format=input_format or None, device=device)
    if output_format in ("analysis", "analysis.h5", "h5"):
        from sleap_tpu_torch.info.write_tracking_h5 import export_analysis_file

        out = output_path or (input_path + ".analysis.h5")
        export_analysis_file(labels, out, labels_path=input_path)
        return out
    if output_format in ("analysis.csv", "csv"):
        from sleap_tpu_torch.info.write_tracking_h5 import export_analysis_file

        out = output_path or (input_path + ".analysis.csv")
        export_analysis_file(labels, out, labels_path=input_path, csv=True)
        return out
    if output_format in ("slp", "pkg.slp"):
        out = output_path or (os.path.splitext(input_path)[0] + f".{output_format}")
        labels.save(out, with_images=(output_format == "pkg.slp"))
        return out
    if output_format == "nwb":
        out = output_path or (os.path.splitext(input_path)[0] + ".nwb")
        labels.export_nwb(out)
        return out
    if output_format == "nix":
        out = output_path or (os.path.splitext(input_path)[0] + ".nix")
        labels.export_nix(out)
        return out
    raise ValueError(f"Unsupported output format: {output_format!r}.")


def main(args=None, device="cuda") -> None:
    import argparse

    from sleap_tpu_torch.io import formats

    parser = argparse.ArgumentParser(description="Convert between label formats.")
    parser.add_argument("input_path")
    parser.add_argument("-o", "--outputs", action="append", default=[],
                        help="Output path (repeatable: one per video for analysis formats).")
    parser.add_argument("--input_format", default="")
    parser.add_argument("--format", default="slp",
                        help="slp | h5 | json | pkg.slp | nwb | analysis | analysis.csv | analysis.nix")
    parser.add_argument("--video", default="",
                        help="Only convert this video (substring match on the video path).")
    ns = parser.parse_args(args)

    labels = formats.read(ns.input_path, as_format=ns.input_format or None, device=device)

    if "analysis" in ns.format or ns.format == "csv":
        from sleap_tpu_torch.info.write_tracking_h5 import export_analysis_file

        if ns.video:
            vids = [v for v in labels.videos if ns.video in v.backend.filename][:1]
        else:
            vids = labels.videos
        out_suffix = "nix" if "nix" in ns.format else "csv" if "csv" in ns.format else "h5"
        outnames: List[str] = list(ns.outputs)
        if len(outnames) < len(vids):
            fn = re.sub(r"(\.json(\.zip)?|\.h5|\.slp)$", "", ns.input_path)
            for video in vids[len(outnames):]:
                outnames.append(default_analysis_filename(
                    labels=labels, video=video, output_path=os.path.dirname(fn) or ".",
                    output_prefix=os.path.basename(fn), format_suffix=out_suffix))
        for video, outname in zip(vids, outnames):
            try:
                if out_suffix == "nix":
                    labels.export_nix(outname, video=video)
                else:
                    export_analysis_file(labels, outname, labels_path=ns.input_path, all_frames=True,
                                         video=video, csv=(out_suffix == "csv"))
                print(f"Saved: {outname}")
            except ValueError as e:  # a video without labeled frames: no file
                print(e.args[0] if e.args else e)
    elif ns.outputs:
        out = ns.outputs[0]
        labels.save(out, with_images=(ns.format == "pkg.slp"))
        print(f"Output SLEAP dataset: {out}")
    elif ns.format in ("slp", "h5", "json", "pkg.slp", "nwb", "nix"):
        if ns.format in ("slp", "h5", "json"):
            out = f"{ns.input_path}.{ns.format}"
            labels.save(out)
        else:
            out = convert(ns.input_path, input_format=ns.input_format, output_format=ns.format,
                          device=device)
        print(f"Output SLEAP dataset: {out}")
    else:
        print("You didn't specify how to convert the file.")
        print(ns)


if __name__ == "__main__":
    main()
