"""Persisted user settings (counterpart of the JAX package's
``utils/settings.py``): a versioned JSON of the datasets, weights and runs
directories and feature toggles at ``~/.config/ycr_tpu_torch/settings.json``,
made on first use, reset on a version change (the directories kept) or
when it does not parse."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

SETTINGS_PATH = Path.home() / ".config" / "ycr_tpu_torch" / "settings.json"

DEFAULTS: Dict[str, Any] = {
    "settings_version": "0.1.0",
    "datasets_dir": str(Path.home() / "datasets"),
    "weights_dir": str(Path.home() / "weights"),
    "runs_dir": "runs",
    "tensorboard": True,
    "sync": False,
}


class SettingsManager(dict):
    def __init__(self, path=None):
        super().__init__(DEFAULTS)
        # read at call time, so that a caller can point SETTINGS_PATH elsewhere
        self.path = Path(path or SETTINGS_PATH)
        try:
            if self.path.exists():
                loaded = json.loads(self.path.read_text())
                if loaded.get("settings_version") == DEFAULTS["settings_version"]:
                    self.update(loaded)
                else:  # another version: the defaults, the directories kept
                    for k in ("datasets_dir", "weights_dir", "runs_dir"):
                        if k in loaded:
                            self[k] = loaded[k]
                    self.save()
            else:
                self.save()
        except (json.JSONDecodeError, OSError):
            self.reset()

    def save(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(dict(self), indent=2))

    def reset(self):
        self.clear()
        self.update(DEFAULTS)
        self.save()


SETTINGS = None


def get_settings() -> SettingsManager:
    global SETTINGS
    if SETTINGS is None:
        SETTINGS = SettingsManager()
    return SETTINGS
