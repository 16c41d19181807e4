"""Runtime render-settings editor, the "Constants Editor" analog (port of
``raytracer3_tpu/app/tuner.py``, the same knobs and text protocol):

    tuner = SettingsTuner(settings)
    tuner.apply("bounces=6 samples=2")     # returns new RenderSettings
    tuner.apply("blendfactor=0.2")         # dynamic knobs tracked separately

A static knob (bounces, samples, resolution, ...) flags a rebuild of the
frame function, where the reference recompiles its jitted program; the
dynamic knobs (blendfactor, cell_size, proberng) are values the caller feeds
into the frame function.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from raytracer3_tpu_torch.utils.config import RenderSettings

# Knobs that shape the frame function: a change rebuilds it.
STATIC_KNOBS = {
    "width", "height", "bounces", "samples", "probe_spacing", "probe_res",
    "diffuse_only", "radiance_clamp",
}
# Knobs the caller feeds into the frame function as values (no rebuild).
DYNAMIC_KNOBS = {"blendfactor", "cell_size", "proberng"}


@dataclasses.dataclass
class DynamicState:
    blendfactor: float = 0.0  # 0 → progressive 1/(n+1)
    cell_size: float = 0.01
    proberng: bool = False


class SettingsTuner:
    def __init__(self, settings: RenderSettings, dynamic: DynamicState | None = None):
        self.settings = settings
        self.dynamic = dynamic or DynamicState()
        self.recompile_needed = False

    def apply(self, command: str) -> Tuple[RenderSettings, DynamicState]:
        """Apply "key=value [key=value ...]"; returns (settings, dynamic)."""
        for tok in command.split():
            if "=" not in tok:
                raise ValueError(f"expected key=value, got {tok!r}")
            key, val = tok.split("=", 1)
            if key in STATIC_KNOBS:
                cur = getattr(self.settings, key)
                new = type(cur)(float(val)) if not isinstance(cur, bool) else val.lower() in ("1", "true", "on")
                if new != cur:
                    self.settings = dataclasses.replace(self.settings, **{key: new})
                    self.recompile_needed = True
            elif key in DYNAMIC_KNOBS:
                cur = getattr(self.dynamic, key)
                new = type(cur)(float(val)) if not isinstance(cur, bool) else val.lower() in ("1", "true", "on")
                setattr(self.dynamic, key, new)
            else:
                raise ValueError(
                    f"unknown knob {key!r}; static={sorted(STATIC_KNOBS)}, "
                    f"dynamic={sorted(DYNAMIC_KNOBS)}"
                )
        return self.settings, self.dynamic

    def consume_recompile_flag(self) -> bool:
        f = self.recompile_needed
        self.recompile_needed = False
        return f

    def dump(self) -> str:
        lines = ["# static (rebuild the frame function on change)"]
        for k in sorted(STATIC_KNOBS):
            lines.append(f"{k}={getattr(self.settings, k)}")
        lines.append("# dynamic")
        for k in sorted(DYNAMIC_KNOBS):
            lines.append(f"{k}={getattr(self.dynamic, k)}")
        return "\n".join(lines)
