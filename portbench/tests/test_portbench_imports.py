"""The benchmark loads no JAX and no module of the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's), and
its plain reference loads nothing of the program under test."""

from __future__ import annotations

import subprocess
import sys
import types
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]


def _loaded_after(code: str) -> set:
    """Top-level names in sys.modules after running `code` in a fresh process."""
    probe = code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_everything_the_run_loads_is_free_of_jax():
    code = ("import importlib, pathlib, sys\n"
            "sys.argv = ['run']\n"
            "import portbench.run, portbench.calibrate\n"
            "from portbench import harness\n"
            "for d in pathlib.Path('portbench/drivers').glob('[a-z]*.py'):\n"
            "    harness.driver(d.stem)\n"
            "for m in pathlib.Path('portbench/metrics').glob('[a-z]*.py'):\n"
            "    harness.metric_reader(m.stem)\n")
    loaded = _loaded_after(code)
    assert "se_unet_airseg_tpu_torch" in loaded  # the program is loaded ...
    assert not loaded & set(harness.FORBIDDEN)  # ... and nothing of JAX's side


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import portbench.reference.seunet, portbench.reference.volume, "
                           "portbench.reference.stage1_data, portbench.reference.spec, "
                           "portbench.counts")
    assert "se_unet_airseg_tpu_torch" not in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("se_unet_airseg_tpu_torch", "jaxtyping_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "se_unet_airseg_tpu.models",
                        types.ModuleType("se_unet_airseg_tpu.models"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax", "se_unet_airseg_tpu"]
