"""The pair-tile kernels' skip test, and the plain versions on mixed lanes (CPU).

The CUDA kernels K3/K4 (`etx_tracer_tpu_torch/csrc/brute2_trace.cu`) skip a
ray with t_max <= 0 and t_min > 1e-30 (`brute2_trace.dead_lanes`) and write
its miss at once; the plain versions test it like any other ray. The two
agree only if such a ray has no valid pair under the float32 rounding of
`brute2_trace._pairs`: a valid pair needs dd > 1e-9, so RN(t_min * dd) > 0
>= RN(t_max * dd), and no tt lies in between. These tests hold that, at the
extremes too, show that neither bound of the test can be loosened, and hold
the plain versions on rays with dead lanes interleaved to the results with
those lanes removed.
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from etx_tracer_tpu_torch.ops import _build, brute2_trace

torch.set_num_threads(1)

F32 = np.float32
EPS_UP = float(np.nextafter(F32(1e-9), F32(1.0)))       # least dd that passes dd > 1e-9
SKIP_UP = float(np.nextafter(F32(1e-30), F32(1.0)))     # least t_min that the test skips
T_MAX_DEAD = [0.0, -0.0, -1.0, -1e-38]


def _t(*xs):
  return [torch.tensor(x, dtype=torch.float32) for x in xs]


def _interval(tt, dd, t_min, t_max):
  """The interval part of `_pairs`' validity test, as it rounds there."""
  return (tt >= t_min * dd) & (tt <= t_max * dd)


def _axis_pair(s, u, v, z, t_min, t_max):
  """`_pairs` for a ray along +z from (u s, v s, z) against the triangle
  v0 = 0, e1 = (s, 0, 0), e2 = (0, s, 0): det = -s^2, a = u s^2, b = v s^2
  and tt = -z s^2 (the hit is at t = -z). Returns (ok, dd, tt)."""
  v0 = torch.zeros((1, 3))
  e1 = torch.tensor([[s, 0.0, 0.0]], dtype=torch.float32)
  e2 = torch.tensor([[0.0, s, 0.0]], dtype=torch.float32)
  col = lambda x: torch.tensor([[x]], dtype=torch.float32)
  ray = (col(u * s), col(v * s), col(z), col(0.0), col(0.0), col(1.0), col(t_min), col(t_max))
  ok, _, _, tt, dd = brute2_trace._pairs(v0, e1, e2, ray)
  return bool(ok[0, 0]), float(dd[0, 0]), float(tt[0, 0])


def _f32(lo=None, hi=None, **kw):
  """float32 values in [lo, hi], the bounds rounded to float32 first."""
  lo, hi = (None if x is None else float(F32(x)) for x in (lo, hi))
  return st.floats(min_value=lo, max_value=hi, width=32, allow_nan=False, **kw)


def test_kernel_constants_match_the_plain_version():
  src = (_build.SRC_DIR / "brute2_trace.cu").read_text()
  skip = re.search(r"kSkipTMin = ([0-9.e+-]+)f;", src).group(1)
  eps = re.search(r"kMtEps = ([0-9.e+-]+)f;", src).group(1)
  assert F32(skip) == F32(brute2_trace.SKIP_T_MIN)
  assert F32(eps) == F32(brute2_trace._MT_EPS)


@pytest.mark.parametrize("t_max", T_MAX_DEAD)
@pytest.mark.parametrize("t_min", [SKIP_UP, 1e-20, 2.3e-4, 1.0, float("inf")])
def test_extremes_of_a_skipped_lane_admit_no_tt(t_min, t_max):
  assert bool(brute2_trace.dead_lanes(*_t([t_min], [t_max]))[0])
  tiny = float(np.finfo(F32).smallest_subnormal)
  tts = [0.0, -0.0, tiny, -tiny, 1e-45, 1e-38, -1e-38, 1.0, -1.0, 3e38, -3e38,
         float("inf"), float("-inf")]
  for dd in (EPS_UP, 2e-9, 1.0, 3e38):
    tt, dd_t, lo, hi = _t(tts, [dd] * len(tts), [t_min] * len(tts), [t_max] * len(tts))
    assert not _interval(tt, dd_t, lo, hi).any(), (t_min, t_max, dd)


@settings(max_examples=300, deadline=None)
@given(dd=_f32(1e-9, exclude_min=True), tt=st.floats(width=32, allow_nan=False),
       t_min=_f32(1e-30, exclude_min=True), t_max=_f32(hi=0.0))
def test_interval_of_a_skipped_lane_is_empty(dd, tt, t_min, t_max):
  tt, dd, t_min, t_max = _t(tt, dd, t_min, t_max)
  assert bool(brute2_trace.dead_lanes(t_min, t_max))
  assert not bool(_interval(tt, dd, t_min, t_max))


@settings(max_examples=200, deadline=None)
@given(s=_f32(float(np.sqrt(F32(1.001e-9))), 1e-2), u=_f32(0.0, 0.45), v=_f32(0.0, 0.45),
       z=st.one_of(st.sampled_from([0.0, -0.0, 1e-45, -1e-45, 1e-38, -1e-38]),
                   _f32(-1.0, 1.0)),
       t_min=st.one_of(st.just(SKIP_UP), _f32(1e-30, 1.0, exclude_min=True)),
       t_max=st.one_of(st.sampled_from(T_MAX_DEAD), _f32(-1.0, 0.0)))
def test_pairs_of_a_skipped_lane_are_never_valid(s, u, v, z, t_min, t_max):
  # dd from just above 1e-9 up; a and b inside the triangle, so only the
  # interval decides
  assert bool(brute2_trace.dead_lanes(*_t(t_min, t_max)))
  ok, dd, tt = _axis_pair(s, u, v, z, t_min, t_max)
  assert not ok, (dd, tt)
  # the same pair with an open interval is valid where its dd passes: the
  # test above is not vacuous
  ok_open, dd, _ = _axis_pair(s, u, v, z, -2.0, 2.0)
  assert ok_open == (dd > brute2_trace._MT_EPS)


def test_neither_bound_of_the_skip_test_can_be_loosened():
  # t_min at 1e-30 itself is not skipped: the bound is strict
  assert not bool(brute2_trace.dead_lanes(*_t(1e-30, 0.0)))
  # t_min = t_max = 0 is not empty: a ray starting on the triangle (tt = 0)
  assert not bool(brute2_trace.dead_lanes(*_t(0.0, 0.0)))
  ok, dd, tt = _axis_pair(1e-2, 0.25, 0.25, 0.0, 0.0, 0.0)
  assert ok and tt == 0.0 and dd > 1e-9
  # t_max < t_min alone is not empty: both products round to one subnormal
  dd, t_min = _t(1.5e-9, 2e-36)
  t_max = torch.nextafter(t_min, torch.tensor(0.0))
  tt = t_min * dd
  assert float(t_max) < float(t_min) and float(tt) > 0.0
  assert bool(_interval(tt, dd, t_min, t_max))


def _soup(rng, num_t, num_r):
  v0 = rng.uniform(-1.0, 1.0, (num_t, 3)).astype(F32)
  e1 = rng.uniform(-0.6, 0.6, (num_t, 3)).astype(F32)
  e2 = rng.uniform(-0.6, 0.6, (num_t, 3)).astype(F32)
  o = rng.uniform(-1.5, 1.5, (num_r, 3)).astype(F32)
  d = rng.normal(size=(num_r, 3)).astype(F32)
  ti = rng.integers(0, num_t, num_r // 2)
  d[: num_r // 2] = v0[ti] + 0.3 * e1[ti] + 0.3 * e2[ti] - o[: num_r // 2]  # hits
  d /= np.linalg.norm(d, axis=1, keepdims=True)
  t_min = np.full(num_r, 1e-4, F32)
  t_max = np.where(rng.uniform(size=num_r) < 0.2, rng.uniform(0.0, 2.0, num_r), 100.0).astype(F32)
  return [torch.from_numpy(x) for x in (v0, e1, e2, o, d, t_min, t_max)]


@pytest.mark.parametrize("num_t,masked", [(129, False), (600, True)])
@settings(max_examples=15, deadline=None)
@given(dead=st.lists(st.booleans(), min_size=64, max_size=64),
       t_min=st.sampled_from([SKIP_UP, 1e-4, 2.3e-4, 1.0]),
       t_max=st.sampled_from(T_MAX_DEAD), seed=st.integers(0, 2**16))
def test_plain_versions_on_dead_lanes_interleaved(num_t, masked, dead, t_min, t_max, seed):
  rng = np.random.default_rng(seed)
  v0, e1, e2, o, d, lo, hi = _soup(rng, num_t, 64)
  mask = torch.from_numpy(rng.uniform(size=num_t) > 0.3) if masked else None
  dead = torch.tensor(dead)
  lo = torch.where(dead, t_min, lo)
  hi = torch.where(dead, t_max, hi)
  assert torch.equal(brute2_trace.dead_lanes(lo, hi), dead)
  hit = brute2_trace.intersect_plain(v0, e1, e2, o, d, lo, hi, tri_mask=mask)
  occ = brute2_trace.occluded_plain(v0, e1, e2, o, d, lo, hi, tri_mask=mask)
  live = ~dead
  alone = brute2_trace.intersect_plain(v0, e1, e2, o[live], d[live], lo[live], hi[live],
                                       tri_mask=mask)
  for got, want in zip(hit, alone):
    assert torch.equal(got[live], want)
  assert torch.equal(occ[live], brute2_trace.occluded_plain(
      v0, e1, e2, o[live], d[live], lo[live], hi[live], tri_mask=mask))
  # a dead lane gets the miss a plain miss gets: t = +inf, tri = -1, u = v = 0
  none = brute2_trace.intersect_plain(v0[:0], e1[:0], e2[:0], o[dead], d[dead], lo[dead],
                                      hi[dead])
  for got, want in zip(hit, none):
    assert torch.equal(got[dead], want)
  assert bool(torch.isinf(hit.t[dead]).all()) and bool((hit.tri[dead] == -1).all())
  assert bool((hit.u[dead] == 0.0).all()) and bool((hit.v[dead] == 0.0).all())
  assert not bool(occ[dead].any())
  assert torch.equal(occ, hit.found)
