"""The tools that take their settings from chip_smoke.py, on the CPU.

1. Each probe tool of tools/ imports, and every settings function of
   chip_smoke.py that it calls as `cs.<name>(smoke.cfg)` builds the port's
   Settings from the port's config module, as the tool calls it on the card
   (the tools' own main() needs a card).
2. tools/color_tracker_replay.py imports (it imports chip_smoke.py by name)
   and its settings_for() builds the same settings from either package's
   config module, field for field: the port bench's 1 cm point with colour
   fusion and the colour tracker.
3. The smoke's settings functions, given the port's config module, equal
   the port bench's (infinitam_tpu_torch/bench.py), field for field.
"""

import ast
import dataclasses
import enum
import importlib.util
from pathlib import Path

import pytest

from infinitam_tpu_torch import bench
from infinitam_tpu_torch import config as t_cfg

REPO = Path(__file__).resolve().parents[1]
PROBE_TOOLS = ("lane_kernel_probe", "integrate_rows_probe", "raycast_lookahead_probe")


def load(path: Path, name: str):
    """The module at `path`, executed as the tools load chip_smoke.py."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def plain(obj):
    """A dataclass as nested dicts, enums by value (comparable across packages)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    return obj


def smoke_settings_calls(path: Path) -> list:
    """The settings functions of chip_smoke.py (bound as `cs`) that a tool
    calls, with the source of each call's arguments."""
    calls = []
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name) and node.func.value.id == "cs"
                and node.func.attr.endswith("_settings")):
            calls.append((node.func.attr, [ast.unparse(a) for a in node.args]))
    return calls


@pytest.mark.parametrize("tool", PROBE_TOOLS)
def test_probe_tool_builds_its_settings(tool):
    path = REPO / "tools" / f"{tool}.py"
    load(path, f"tool_{tool}")
    cs = load(REPO / "chip_smoke.py", "chip_smoke")
    calls = smoke_settings_calls(path)
    assert calls, f"{tool} calls no settings function of chip_smoke.py"
    for name, args in calls:
        assert args == ["smoke.cfg"], f"{tool} calls cs.{name}({', '.join(args)})"
        assert isinstance(getattr(cs, name)(t_cfg), t_cfg.Settings)


def test_color_tracker_replay_builds_its_settings_from_either_package():
    from infinitam_tpu import config as j_cfg

    tool = load(REPO / "tools" / "color_tracker_replay.py", "tool_color_tracker_replay")
    t_settings = tool.settings_for(t_cfg)
    assert isinstance(t_settings, t_cfg.Settings) and isinstance(tool.settings_for(j_cfg), j_cfg.Settings)
    assert plain(t_settings) == plain(tool.settings_for(j_cfg))
    expected = bench.teddy_1cm_settings().replace(use_color=True, tracker_type=t_cfg.TrackerType.COLOR)
    assert plain(t_settings) == plain(expected)


@pytest.mark.parametrize("name, expected", [
    ("reference_settings", bench.reference_settings),
    ("teddy_1cm_settings", bench.teddy_1cm_settings),
    ("color_settings", lambda: bench.teddy_1cm_settings().replace(use_color=True)),
])
def test_smoke_settings_equal_the_bench(name, expected):
    cs = load(REPO / "chip_smoke.py", "chip_smoke")
    assert plain(getattr(cs, name)(t_cfg)) == plain(expected())
