"""User preferences: :mod:`sleap_tpu.prefs` for the port.

A dict of preferences, loaded on first use from the JAX package's file,
``~/.sleap_tpu/preferences.yaml``, over the same defaults. The file is read
by the port's YAML reader (:func:`sleap_tpu_torch.io.yamlsubset.yaml_load`,
which needs no PyYAML) and written by PyYAML, imported when saving, as the
JAX package writes it; where PyYAML is absent, saving raises ``ImportError``
naming it.
"""

from __future__ import annotations

import os
from typing import Any

from sleap_tpu_torch.io.yamlsubset import yaml_load


class Preferences:
    _prefs = None
    _defaults = {
        "medium step size": 10,
        "large step size": 100,
        "color predicted": False,
        "propagate track labels": True,
        "palette": "standard",
        "bold lines": False,
        "trail length": 0,
        "trail width": 4.0,
        "trail node count": 1,
        "marker size": 4,
        "edge style": "Line",
        "window state": b"",
        "node label size": 12,
        "show non-visible nodes": True,
        "share usage data": False,
    }
    _filename = os.path.expanduser("~/.sleap_tpu/preferences.yaml")

    def load(self) -> None:
        if self._prefs is None:
            self.load_()

    def load_(self) -> None:
        self._prefs = dict(self._defaults)
        try:
            with open(self._filename) as f:
                loaded = yaml_load(f.read()) or {}
            self._prefs.update(loaded)
        except FileNotFoundError:
            pass

    def save(self) -> None:
        try:
            import yaml
        except ImportError as e:
            raise ImportError("Saving preferences needs PyYAML (pip install pyyaml).") from e

        os.makedirs(os.path.dirname(self._filename), exist_ok=True)
        with open(self._filename, "w") as f:
            yaml.dump({k: v for k, v in (self._prefs or {}).items() if not isinstance(v, bytes)}, f)

    def reset_to_default(self) -> None:
        self._prefs = dict(self._defaults)
        self.save()

    def _validate_key(self, key: str) -> None:
        if key not in self._defaults:
            raise KeyError(f"No preference matching '{key}'")

    def __contains__(self, item) -> bool:
        return item in self._defaults

    def __getitem__(self, key: str) -> Any:
        self.load()
        self._validate_key(key)
        return self._prefs.get(key, self._defaults.get(key))

    def __setitem__(self, key: str, value: Any) -> None:
        self.load()
        self._validate_key(key)
        self._prefs[key] = value


prefs = Preferences()
