"""Scenario files, one per BASELINE config (RaiSim loads worlds from XML
world-description files; here each config is a JSON file, a copy of the JAX
package's YAML, consumed by its example)."""

from raisimlib_torch.scenarios.loader import build_scene, build_world, load, scenario_path

__all__ = ["build_scene", "build_world", "load", "scenario_path"]
