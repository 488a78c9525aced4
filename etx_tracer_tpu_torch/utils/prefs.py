"""App preferences: the last integrator and a recent-scene list.

Counterpart of `etx_tracer_tpu/utils/prefs.py`: the same file
(`$ETX_TPU_CONFIG_DIR/options.json`, default `~/.config/etx_tracer_tpu`)
in the same format, so both packages share a user's recent scenes. CLI
renders record the scene path and the chosen integrator; `cli render
recent` renders the most recent one.
"""

from __future__ import annotations

import json
import os

_MAX_RECENT = 10


def prefs_path() -> str:
  base = os.environ.get("ETX_TPU_CONFIG_DIR") or os.path.join(
      os.path.expanduser("~"), ".config", "etx_tracer_tpu")
  return os.path.join(base, "options.json")


def load() -> dict:
  try:
    with open(prefs_path()) as f:
      d = json.load(f)
    return d if isinstance(d, dict) else {}
  except (OSError, ValueError):
    return {}


def save(prefs: dict) -> None:
  path = prefs_path()
  os.makedirs(os.path.dirname(path), exist_ok=True)
  tmp = path + ".tmp"
  with open(tmp, "w") as f:
    json.dump(prefs, f, indent=2, sort_keys=True)
  os.replace(tmp, path)


def add_recent(scene_path: str, integrator: str | None = None,
               **extra) -> dict:
  """Record a scene open (app.cxx:114-124 semantics: de-dup, most recent
  first, bounded list). Returns the updated prefs dict."""
  prefs = load()
  ap = os.path.abspath(scene_path)
  recent = [r for r in prefs.get("recent_files", []) if r != ap]
  recent.insert(0, ap)
  prefs["recent_files"] = recent[:_MAX_RECENT]
  if integrator:
    prefs["integrator"] = integrator
  for k, v in extra.items():
    prefs[k] = v
  try:
    save(prefs)
  except OSError:
    pass  # read-only home: prefs are best-effort, never fatal
  return prefs


def recent_files() -> list:
  return [r for r in load().get("recent_files", []) if os.path.exists(r)]
