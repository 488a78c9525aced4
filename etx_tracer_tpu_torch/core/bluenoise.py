"""Blue-noise-rotated low-discrepancy samples for the first bounce.

Counterpart of `etx_tracer_tpu/core/bluenoise.py`'s `sample_2d`: the R2
additive-recurrence point of a sample index, Cranley-Patterson rotated per
pixel by two reads of a 128x128 void-and-cluster rank mask, so that
neighbouring pixels spread their first-bounce errors as blue noise. The
mask is the JAX package's shipped table, copied beside this module
(`bluenoise_mask128.npy`) and read from there; it is never regenerated.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

_MASK_SIZE = 128
_MASK_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bluenoise_mask128.npy")
# R2 sequence constants (generalised golden ratio), as float32
_R2_ALPHA = (float(np.float32(0.7548776662466927)), float(np.float32(0.5698402909980532)))


@functools.lru_cache(maxsize=1)
def mask_np() -> np.ndarray:
  """The (128, 128) float32 rank mask."""
  m = np.load(_MASK_PATH)
  if m.shape != (_MASK_SIZE, _MASK_SIZE):
    raise ValueError(f"{_MASK_PATH}: a {m.shape} mask, not {(_MASK_SIZE, _MASK_SIZE)}")
  return m.astype(np.float32)


_MASKS: dict = {}


def mask(device) -> torch.Tensor:
  """The rank mask on `device`, copied there once."""
  device = torch.device(device)
  if device not in _MASKS:
    _MASKS[device] = torch.from_numpy(mask_np()).to(device)
  return _MASKS[device]


def sample_2d(pixel_x: torch.Tensor, pixel_y: torch.Tensor, sample_index: torch.Tensor,
              dimension: int = 0) -> torch.Tensor:
  """The blue-noise-rotated R2 point of (pixel, sample, dimension): (R,2)
  in [0, 1)."""
  m = mask(pixel_x.device)
  mx = (pixel_x + 31 * dimension) % _MASK_SIZE
  my = (pixel_y + 17 * dimension) % _MASK_SIZE
  offset = m[my, mx]
  offset2 = m[(my + 29) % _MASK_SIZE, (mx + 43) % _MASK_SIZE]
  s = sample_index.to(torch.float32) + 1.0
  u = torch.fmod(s * _R2_ALPHA[0] + offset, 1.0)
  v = torch.fmod(s * _R2_ALPHA[1] + offset2, 1.0)
  return torch.stack([u, v], dim=-1)
