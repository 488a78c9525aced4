"""Blue-noise-rotated low-discrepancy samples for the first bounce.

Counterpart of `etx_tracer_tpu/core/bluenoise.py`'s `sample_2d`: the R2
additive-recurrence point of a sample index, Cranley-Patterson rotated per
pixel by two reads of a 128x128 void-and-cluster rank mask, so that
neighbouring pixels spread their first-bounce errors as blue noise. The
mask is the JAX package's shipped table, copied beside this module
(`bluenoise_mask128.npy`) and read from there. `generate_mask` is the
offline void-and-cluster generator that made it (numpy; about 20 s at
128 x 128), which nothing calls at run time.
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


def generate_mask(n: int = 128, sigma: float = 1.9, seed: int = 0x5EED) -> np.ndarray:
  """The full three-phase void-and-cluster rank mask (Ulichney 1993) on an
  n x n torus: (n, n) float32 ranks (r + 0.5) / n^2. Energies update by one
  Gaussian splat a rank, so it takes O(n^4) numpy work."""
  rs = np.random.RandomState(seed)
  total = n * n
  d = np.minimum(np.arange(n), n - np.arange(n)).astype(np.float64)
  kern = np.exp(-(d[None, :] ** 2 + d[:, None] ** 2) / (2 * sigma * sigma))

  def splat(e, i, s):
    y, x = divmod(int(i), n)
    e += np.roll(np.roll(kern, y, 0), x, 1) * s

  # the initial pattern: 10% minority points, relaxed to a stable state
  count = total // 10
  binary = np.zeros(total, bool)
  binary[rs.choice(total, count, replace=False)] = True
  energy = np.zeros((n, n))
  for i in np.nonzero(binary)[0]:
    splat(energy, i, 1.0)
  ef = energy.reshape(-1)
  for _ in range(total):
    cluster = int(np.argmax(np.where(binary, ef, -np.inf)))
    binary[cluster] = False
    splat(energy, cluster, -1.0)
    void = int(np.argmin(np.where(binary, np.inf, ef)))
    if void == cluster:
      binary[cluster] = True
      splat(energy, cluster, 1.0)
      break
    binary[void] = True
    splat(energy, void, 1.0)

  rank = np.zeros(total, np.int64)
  # phase 1: remove the tightest cluster, ranks descending
  b = binary.copy()
  e1 = energy.copy()
  e1f = e1.reshape(-1)
  for r in range(count - 1, -1, -1):
    i = int(np.argmax(np.where(b, e1f, -np.inf)))
    b[i] = False
    splat(e1, i, -1.0)
    rank[i] = r
  # phase 2: fill the largest voids until half full
  b = binary.copy()
  e2 = energy.copy()
  e2f = e2.reshape(-1)
  for r in range(count, total // 2):
    i = int(np.argmin(np.where(b, np.inf, e2f)))
    b[i] = True
    splat(e2, i, 1.0)
    rank[i] = r
  # phase 3: the zeros are the minority now; remove their tightest clusters
  zeros_energy = np.zeros((n, n))
  zf = zeros_energy.reshape(-1)
  for i in np.nonzero(~b)[0]:
    splat(zeros_energy, i, 1.0)
  for r in range(total // 2, total):
    i = int(np.argmax(np.where(b, -np.inf, zf)))
    b[i] = True
    splat(zeros_energy, i, -1.0)
    rank[i] = r
  return ((rank.astype(np.float64) + 0.5) / total).astype(np.float32).reshape(n, n)
