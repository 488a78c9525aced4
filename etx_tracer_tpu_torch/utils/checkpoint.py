"""Render checkpoint and resume: the film layers and the iteration count
to and from one `.npz` file.

Counterpart of `etx_tracer_tpu/utils/checkpoint.py`, with the same fields.
A sample's RNG stream keys off its pixel and iteration only, so the film
and its iteration count are all a resumed render needs.
"""

from __future__ import annotations

import numpy as np
import torch

from etx_tracer_tpu_torch import resolve_device
from etx_tracer_tpu_torch.render import film as film_mod

_FIELDS = ("camera", "variance_half", "normals", "albedo", "light",
           "light_iteration", "iteration")


def save_film(path: str, film_state: film_mod.FilmState) -> None:
  np.savez_compressed(path, **{f: getattr(film_state, f).cpu().numpy() for f in _FIELDS})


def load_film(path: str, device=None) -> film_mod.FilmState:
  """The saved film on `device` (default: the CUDA card, which must exist)."""
  device = resolve_device(device)
  with np.load(path) as data:
    return film_mod.FilmState(**{f: torch.as_tensor(data[f], device=device) for f in _FIELDS})


def resume_iteration(film_state: film_mod.FilmState) -> int:
  """The next iteration to render."""
  return int(film_state.iteration.item())
