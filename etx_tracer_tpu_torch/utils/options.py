"""Typed options store with bounds and JSON round-trip.

Counterpart of `etx_tracer_tpu/utils/options.py` and of the reference
Options (util/options.hxx:12-231): typed
key/value entries (bool/int/float/float2/float3/string/enum) with
min/max bounds, used for integrator options and app preferences.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional


@dataclasses.dataclass
class Option:
  name: str
  value: Any
  kind: str  # bool/int/float/float2/float3/string/enum
  min: Optional[float] = None
  max: Optional[float] = None
  choices: Optional[list] = None
  title: str = ""

  def set(self, v):
    if self.kind == "bool":
      self.value = bool(v)
    elif self.kind == "int":
      v = int(v)
      if self.min is not None:
        v = max(int(self.min), v)
      if self.max is not None:
        v = min(int(self.max), v)
      self.value = v
    elif self.kind == "float":
      v = float(v)
      if self.min is not None:
        v = max(self.min, v)
      if self.max is not None:
        v = min(self.max, v)
      self.value = v
    elif self.kind == "enum":
      if self.choices and v in self.choices:
        self.value = v
      elif isinstance(v, int) and self.choices and 0 <= v < len(self.choices):
        self.value = self.choices[v]
    else:
      self.value = v


class Options:
  def __init__(self):
    self._entries: dict[str, Option] = {}

  def add(self, name, value, kind=None, min=None, max=None, choices=None, title=""):
    if kind is None:
      kind = {bool: "bool", int: "int", float: "float", str: "string"}.get(type(value), "string")
    self._entries[name] = Option(name, value, kind, min, max, choices, title or name)
    return self

  def get(self, name, default=None):
    e = self._entries.get(name)
    return e.value if e is not None else default

  def set(self, name, value):
    if name in self._entries:
      self._entries[name].set(value)
    else:
      self.add(name, value)

  def __contains__(self, name):
    return name in self._entries

  def items(self):
    return {k: v.value for k, v in self._entries.items()}

  # JSON round-trip (util/options.cxx)
  def save(self, path: str):
    with open(path, "w") as f:
      json.dump(self.items(), f, indent=2)

  def load(self, path: str):
    with open(path) as f:
      data = json.load(f)
    for k, v in data.items():
      self.set(k, v)
    return self
