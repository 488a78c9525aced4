"""The Woop kernels' skip test, sign test and cull, and the plain versions on mixed lanes (CPU).

The CUDA kernels K9a/K9b (`etx_tracer_tpu_torch/csrc/woop_trace.cu`) skip a
ray whose interval is empty (`woop_trace.dead_lanes`: !(t_min <= t_max),
NaN ends included) and write its miss at once, and K9a divides only for the
pairs that pass its sign test (`woop_trace.sign_candidates`: |q_z| > 1e-7
and, for a ray with t_min > 0, the sign bits of w_z and q_z unequal) and
its cull (RN(|w_z| - cut |q_z|) <= 0 by one fused multiply-add, cut the
next float above the ray's t_max or best t). The plain versions test every
pair. The two agree only if no test drops a pair that `woop_trace._pairs`
finds valid under its float32 rounding and that could win: a valid pair has
t_min <= t <= t_max on one t, and with t_min > 0 a t > 0, which IEEE
division gives only when the signs of -w_z and q_z agree and w_z is not a
zero; a culled pair has t >= cut. These tests hold that at the extremes
(signed zeros, subnormals, infinities, NaN), show that no condition of the
skip and sign tests can be loosened, and hold the plain versions on rays
with dead lanes interleaved to the results with those lanes removed.
"""

import re
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from etx_tracer_tpu_torch.ops import _build, woop_trace

torch.set_num_threads(1)

F32 = np.float32
TINY = float(np.finfo(F32).smallest_subnormal)
EXTREMES = [0.0, -0.0, TINY, -TINY, 1e-38, -1e-38, 1e-7, -1e-7, 1.0, -1.0, 3e38, -3e38,
            float("inf"), float("-inf"), float("nan")]
# a triangle in the plane z = 0 as a Woop row: u = w_x, v = w_y, w_z = o_z
# (for the origin (-1, -1, z): u = v = 0.25), q_z = d_z
AXIS_ROW = [1.0, 0.0, 0.0, 1.25, 0.0, 1.0, 0.0, 1.25, 0.0, 0.0, 1.0, -0.0]


def _f32(**kw):
  """float32 values, the extremes drawn often."""
  return st.one_of(st.sampled_from(EXTREMES), st.floats(width=32, **kw))


def _ray(o, d, t_min, t_max):
  """(R, 1) ray columns, as `_pairs` takes them, of one ray."""
  col = lambda x: torch.tensor([[x]], dtype=torch.float32)
  return tuple(col(x) for x in (*o, *d, t_min, t_max))


def _pair(row, o, d, t_min, t_max):
  """(valid by `_pairs`, passes `sign_candidates`, w_z, q_z, t) of one pair."""
  tab = torch.tensor([row], dtype=torch.float32)
  ray = _ray(o, d, t_min, t_max)
  ok, t, _, _ = woop_trace._pairs(tab, ray)
  cand = woop_trace.sign_candidates(tab, ray)
  nx, ny, nz, nb = tab[0, 8:]
  wz = nx * ray[0] + ny * ray[1] + nz * ray[2] + nb
  qz = nx * ray[3] + ny * ray[4] + nz * ray[5]
  return bool(ok[0, 0]), bool(cand[0, 0]), float(wz[0, 0]), float(qz[0, 0]), float(t[0, 0])


def _axis_pair(z, dz, t_min, t_max):
  """The pair of AXIS_ROW and the ray from (-1, -1, z) along (0, 0, dz):
  inside the triangle (u = v = 0.25), so |q_z| > 1e-7 and the interval
  decide; w_z = z and q_z = dz, bit for bit (dz = -0 gives q_z = +0)."""
  got = _pair(AXIS_ROW, (-1.0, -1.0, z), (0.0, 0.0, dz), t_min, t_max)
  assert np.float32(got[2]).tobytes() == np.float32(z).tobytes()
  return got


def test_kernel_constants_match_the_plain_version():
  src = (_build.SRC_DIR / "woop_trace.cu").read_text()
  const = lambda name: re.search(rf"\b{name} = ([0-9.e+-]+)f?;", src).group(1)
  assert F32(const("kQzEps")) == F32(woop_trace._QZ_EPS)
  assert int(const("kMaxRows")) == woop_trace.MAX_ROWS
  assert int(const("kThreads")) == woop_trace.TILE_RAYS
  assert woop_trace.ROW * 4 == 48  # a staged row: three float4


def test_dead_lanes_is_an_empty_interval():
  nan = float("nan")
  t_min = [1e-4, nan, 1.0, 0.0, 1e-4, 1e-4, 0.0, 1.0, -1.0, float("inf")]
  t_max = [0.0, 1.0, nan, -0.0, -0.0, -1.0, 0.0, 1.0, 1e30, float("inf")]
  want = [True, True, True, False, True, True, False, False, False, False]
  got = woop_trace.dead_lanes(torch.tensor(t_min), torch.tensor(t_max))
  assert got.tolist() == want
  # one ulp above is dead, equal is not
  t = torch.tensor([2.5e-3])
  assert bool(woop_trace.dead_lanes(torch.nextafter(t, torch.tensor(1.0)), t))


@settings(max_examples=200, deadline=None)
@given(z=_f32(), dz=_f32(), t_min=_f32(), t_max=_f32())
def test_a_dead_ray_has_no_valid_pair_inside_a_triangle(z, dz, t_min, t_max):
  assume(bool(woop_trace.dead_lanes(torch.tensor([t_min]), torch.tensor([t_max]))))
  ok, _, _, _, t = _axis_pair(z, dz, t_min, t_max)
  assert not ok, (z, dz, t_min, t_max, t)


@settings(max_examples=200, deadline=None)
@given(row=st.lists(_f32(), min_size=12, max_size=12), o=st.lists(_f32(), min_size=3, max_size=3),
       d=st.lists(_f32(), min_size=3, max_size=3), t_min=_f32(), t_max=_f32())
def test_a_dead_ray_has_no_valid_pair_for_any_row(row, o, d, t_min, t_max):
  assume(bool(woop_trace.dead_lanes(torch.tensor([t_min]), torch.tensor([t_max]))))
  assert not _pair(row, o, d, t_min, t_max)[0]


@settings(max_examples=200, deadline=None)
@given(z=_f32(), dz=_f32(), t_min=_f32(min_value=0.0, exclude_min=True), t_max=_f32())
def test_the_sign_test_drops_no_valid_pair_inside_a_triangle(z, dz, t_min, t_max):
  assume(t_min > 0.0)
  ok, cand, wz, qz, _ = _axis_pair(z, dz, t_min, t_max)
  assert cand or not ok
  # what the test drops: |q_z| <= 1e-7 or equal sign bits; a zero w_z, which
  # it keeps, is never valid either
  same_sign = np.signbit(F32(wz)) == np.signbit(F32(qz))
  assert cand == (abs(qz) > float(F32(woop_trace._QZ_EPS)) and not same_sign)
  assert wz != 0.0 or not ok


@settings(max_examples=200, deadline=None)
@given(row=st.lists(_f32(), min_size=12, max_size=12), o=st.lists(_f32(), min_size=3, max_size=3),
       d=st.lists(_f32(), min_size=3, max_size=3), t_min=_f32(), t_max=_f32())
def test_the_sign_test_drops_no_valid_pair_for_any_row(row, o, d, t_min, t_max):
  ok, cand, _, _, _ = _pair(row, o, d, t_min, t_max)
  assert cand or not ok


def _culled(wz, qz, cut):
  """K9a's cull, RN(|w_z| - cut |q_z|) > 0 in float32 by one fused
  multiply-add, from the exact value: float32's round to nearest, ties to
  even, gives a positive result exactly when the value exceeds 2^-150."""
  if not all(np.isfinite([wz, qz, cut])):
    return bool(np.isinf(wz) and np.isfinite(cut) and np.isfinite(qz))  # +inf - finite
  exact = Fraction(abs(wz)) - Fraction(cut) * Fraction(abs(qz))
  return exact > Fraction(1, 2**150)


@settings(max_examples=200, deadline=None)
@given(z=_f32(), dz=_f32(), c=_f32(min_value=0.0, exclude_min=True))
def test_a_culled_candidate_lies_beyond_the_cut(z, dz, c):
  # c: a positive t_max or best t so far; cut: the next float above it
  assume(c > 0.0)
  cut = float(np.nextafter(F32(c), F32(np.inf)))
  ok, cand, wz, qz, t = _axis_pair(z, dz, TINY, float("inf"))
  if cand and _culled(wz, qz, cut):
    assert t > c, (wz, qz, c, t)  # beyond t_max, or farther than the best
  # and a candidate whose t lies below c is never culled
  if cand and ok and t < c:
    assert not _culled(wz, qz, cut)


def test_neither_test_can_be_loosened():
  # the skip test: t_min == t_max is not empty (t = 1 hits)
  assert _axis_pair(-1.0, 1.0, 1.0, 1.0)[0]
  assert not bool(woop_trace.dead_lanes(torch.tensor([1.0]), torch.tensor([1.0])))
  # ... nor t_min = +0 with t_max = -0: w_z = 0 gives t = -0, which both
  # compares pass
  ok, _, _, _, t = _axis_pair(0.0, 1.0, 0.0, -0.0)
  assert ok and t == 0.0 and np.signbit(F32(t))
  # the sign test needs t_min > 0: at t_min = 0 a zero w_z is valid, and
  # so are equal signs below 0
  ok, cand, wz, _, _ = _axis_pair(0.0, 1.0, 0.0, 1.0)
  assert ok and cand and wz == 0.0
  ok, cand, wz, qz, t = _axis_pair(1.0, 1.0, -1.0, 1.0)
  assert ok and cand and wz > 0.0 and qz > 0.0 and t == -1.0
  # ... and with t_min > 0 the least positive t, from opposite signs, is
  # valid and kept
  ok, cand, wz, qz, t = _axis_pair(-TINY, 1.0, TINY, 1.0)
  assert ok and cand and t == TINY
  # a product w_z * q_z would lose the sign: it underflows to a zero
  ok, cand, wz, qz, _ = _axis_pair(-TINY, 0.5, TINY, 1.0)
  assert ok and cand and F32(wz) * F32(qz) == 0.0


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
@given(dead=st.lists(st.sampled_from(["live", "t_max 0", "t_max -0", "NaN t_min", "ulp above"]),
                     min_size=64, max_size=64),
       seed=st.integers(0, 2**16))
def test_plain_versions_on_dead_lanes_interleaved(num_t, masked, dead, seed):
  rng = np.random.default_rng(seed)
  v0, e1, e2, o, d, lo, hi = _soup(rng, num_t, 64)
  mask = torch.from_numpy(rng.uniform(size=num_t) > 0.3) if masked else None
  for i, kind in enumerate(dead):
    if kind in ("t_max 0", "t_max -0"):
      hi[i] = 0.0 if kind == "t_max 0" else -0.0
    elif kind == "NaN t_min":
      lo[i] = float("nan")
    elif kind == "ulp above":
      lo[i] = torch.nextafter(hi[i], torch.tensor(float("inf")))
  dead = torch.tensor([k != "live" for k in dead])
  assert torch.equal(woop_trace.dead_lanes(lo, hi), dead)
  hit = woop_trace.intersect_plain(v0, e1, e2, o, d, lo, hi, tri_mask=mask)
  occ = woop_trace.occluded_plain(v0, e1, e2, o, d, lo, hi, tri_mask=mask)
  live = ~dead
  alone = woop_trace.intersect_plain(v0, e1, e2, o[live], d[live], lo[live], hi[live],
                                     tri_mask=mask)
  for got, want in zip(hit, alone):
    assert torch.equal(got[live], want)
  assert torch.equal(occ[live], woop_trace.occluded_plain(
      v0, e1, e2, o[live], d[live], lo[live], hi[live], tri_mask=mask))
  # a dead lane gets what a miss gets: t = +inf, tri = -1, u = v = 0
  assert bool(torch.isinf(hit.t[dead]).all()) and bool((hit.tri[dead] == -1).all())
  assert bool((hit.u[dead] == 0.0).all()) and bool((hit.v[dead] == 0.0).all())
  assert not bool(occ[dead].any())
  assert torch.equal(occ, hit.found)
