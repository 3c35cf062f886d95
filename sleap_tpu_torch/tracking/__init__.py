"""Cross-frame identity tracking of predicted instances (port of
:mod:`sleap_tpu.tracking`): :mod:`~sleap_tpu_torch.tracking.tracker` (flow
and simple trackers, the factory ``Tracker.make_tracker_by_name``),
:mod:`~sleap_tpu_torch.tracking.components` (similarities, matching,
culling) and :mod:`~sleap_tpu_torch.tracking.kalman`. ``load_model(...,
tracker="flow")`` attaches a tracker to a predictor."""

from sleap_tpu_torch.tracking.tracker import Tracker, retrack, run_tracker

__all__ = ["Tracker", "retrack", "run_tracker"]
