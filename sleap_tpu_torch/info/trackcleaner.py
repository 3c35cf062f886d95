"""Post-hoc track cleaning (port of :mod:`sleap_tpu.info.trackcleaner`):
cull each frame to a target instance count and reconnect single track
breaks over saved predictions, with the port's
:class:`~sleap_tpu_torch.tracking.tracker.TrackCleaner` (host code).

    python -m sleap_tpu_torch.info.trackcleaner predictions.slp -c 2 [-o out.slp]
"""

from __future__ import annotations

import argparse
from typing import Optional


def fit_tracks(filename: str, instance_count: int, output: Optional[str] = None) -> str:
    from sleap_tpu_torch.core.labels import Labels
    from sleap_tpu_torch.tracking.tracker import TrackCleaner

    labels = Labels.load_file(filename)
    frames = sorted(labels.labeled_frames, key=lambda lf: lf.frame_idx)
    TrackCleaner(instance_count=instance_count).run(frames)
    labels.update_cache()
    out = output or (filename + ".cleaned.slp")
    labels.save(out)
    return out


def main(args=None) -> None:
    parser = argparse.ArgumentParser(description="Clean/cull tracks post hoc.")
    parser.add_argument("data_path")
    parser.add_argument("-c", "--instance_count", type=int, required=True)
    parser.add_argument("-o", "--output", default=None)
    ns = parser.parse_args(args)
    out = fit_tracks(ns.data_path, ns.instance_count, ns.output)
    print(f"Saved: {out}")


if __name__ == "__main__":
    main()
