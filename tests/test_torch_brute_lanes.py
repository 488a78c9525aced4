"""K1/K2's skip test, and the plain versions on mixed lanes (CPU).

The CUDA kernels K1/K2 (`etx_tracer_tpu_torch/csrc/brute_trace.cu`) skip a
ray with !(t_min <= t_max) or t_max < 0 (`brute_trace.dead_lanes`) and write
its miss at once; the plain versions test it like any other ray. The two
agree only if such a ray has no valid pair: the plain versions compare the
rounded t itself with t_min and t_max, so no t lies in an interval whose
ends are out of order or NaN, and they drop a ray with t_max < 0. These
tests hold that at the float32 extremes (NaN, +-0, subnormals, bounds one
ulp apart) on rays built to hit at exactly chosen distances, show that
neither part of the test can be dropped, hold the plain versions on rays
with dead lanes interleaved to the results with those lanes removed, and
hold the same rays against the JAX package's CPU route.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from etx_tracer_tpu.ops import trace as jtrace
from etx_tracer_tpu_torch.ops import brute_trace

torch.set_num_threads(1)

F32 = np.float32
TINY = float(np.finfo(F32).smallest_subnormal)
EDGES = [0.0, -0.0, float("nan"), float("inf"), float("-inf"), TINY, -TINY, 1e-38, -1e-38,
         1e-4, 1.0, -1.0, 3e38, -3e38]
# dead intervals of the main path (t_max = 0 under t_min = 1e-4) and of the
# extremes: out of order by one ulp, NaN at either end, t_max < 0
UP = float(np.nextafter(F32(1.0), F32(2.0)))
DEAD = [(1e-4, 0.0), (1e-4, -0.0), (float("nan"), 1.0), (1.0, float("nan")), (UP, 1.0),
        (TINY, 0.0), (0.0, -TINY), (-2.0, -1.0)]
# JAX's `intersect_scan` does not drop a ray with t_max < 0 whose interval
# holds a t: compared there only on the empty intervals
EMPTY = [x for x in DEAD if x != (-2.0, -1.0)]
T_RTOL = 1e-5   # hit distance, relative: XLA fuses multiply-adds, the port rounds each operation


def _f32(**kw):
  return st.floats(width=32, **kw)


def _t(*xs):
  return [torch.tensor(x, dtype=torch.float32) for x in xs]


# one triangle, v0 = 0, e1 = (1, 0, 0), e2 = (0, 1, 0); a ray along +z from
# (0.25, 0.25, -h) meets it at t = h exactly (det = -1, u = v = 0.25)
_TRI = [torch.tensor([[0.0, 0.0, 0.0]]), torch.tensor([[1.0, 0.0, 0.0]]),
        torch.tensor([[0.0, 1.0, 0.0]])]


def _rays_hitting_at(hs):
  o = torch.tensor([[0.25, 0.25, -h] for h in hs], dtype=torch.float32)
  d = torch.tensor([[0.0, 0.0, 1.0]] * len(hs), dtype=torch.float32)
  return o, d


def _near(*xs):
  """Each finite x and its float32 neighbours, and the zeros and least
  subnormals."""
  out = [0.0, -0.0, TINY, -TINY]
  for x in xs:
    x = F32(x)
    if np.isfinite(x):
      out += [float(x), float(np.nextafter(x, F32(np.inf))), float(np.nextafter(x, F32(-np.inf)))]
  return [h for h in out if np.isfinite(F32(-h))]


@settings(max_examples=300, deadline=None)
@given(t_min=st.one_of(st.sampled_from(EDGES), _f32()), t_max=st.one_of(st.sampled_from(EDGES), _f32()),
       ulp=st.sampled_from([None, 1, -1]))
def test_a_dead_ray_misses_at_every_distance(t_min, t_max, ulp):
  if ulp is not None and np.isfinite(F32(t_max)):
    # bounds one ulp apart, the lower one above
    t_min = float(np.nextafter(F32(t_max), F32(np.inf) if ulp > 0 else F32(-np.inf)))
  lo, hi = _t([t_min], [t_max])
  dead = bool(brute_trace.dead_lanes(lo, hi)[0])
  hs = _near(t_min, t_max)
  o, d = _rays_hitting_at(hs)
  n = len(hs)
  lo, hi = lo.expand(n).contiguous(), hi.expand(n).contiguous()
  hit = brute_trace.intersect_plain(*_TRI, o, d, lo, hi)
  occ = brute_trace.occluded_plain(*_TRI, o, d, lo, hi)
  # the rays do hit at those distances: with an open interval every one is found
  wide = brute_trace.intersect_plain(*_TRI, o, d, *_t([float("-inf")] * n, [float("inf")] * n))
  assert bool(wide.found.all()) and torch.equal(wide.t, torch.tensor(hs, dtype=torch.float32))
  # each ray is found exactly when its t lies in the interval and t_max >= 0
  h = torch.tensor(hs, dtype=torch.float32)
  inside = (lo <= h) & (h <= hi) & (hi >= 0.0)
  assert torch.equal(hit.found, inside) and torch.equal(occ, inside)
  if dead:
    assert not bool(inside.any())
    assert bool(torch.isinf(hit.t).all()) and bool((hit.tri == -1).all())
    assert bool((hit.u == 0.0).all()) and bool((hit.v == 0.0).all())


def test_neither_part_of_the_skip_test_can_be_dropped():
  # t_min == t_max is not empty: the ray at exactly that t hits
  for x in (0.0, -0.0, 1e-4, 1.0):
    lo, hi = _t([x], [x])
    assert not bool(brute_trace.dead_lanes(lo, hi)[0])
    hit = brute_trace.intersect_plain(*_TRI, *_rays_hitting_at([abs(x)]), lo, hi)
    assert bool(hit.found[0]) and float(hit.t[0]) == float(F32(x))
  # an ordered interval below 0 holds a t, but the plain versions drop the
  # ray: the t_max < 0 part is needed
  lo, hi = _t([-2.0], [-1.0])
  assert bool(brute_trace.dead_lanes(lo, hi)[0]) and bool((lo <= hi)[0])
  o, d = _rays_hitting_at([-1.5])
  assert not bool(brute_trace.intersect_plain(*_TRI, o, d, lo, hi).found[0])
  assert not bool(brute_trace.occluded_plain(*_TRI, o, d, lo, hi)[0])
  wide = brute_trace.intersect_plain(*_TRI, o, d, *_t([-2.0], [1.0]))
  assert bool(wide.found[0]) and float(wide.t[0]) == -1.5


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
  return v0, e1, e2, o, d, t_min, t_max


def _interleave(rng, t_min, t_max, dead, pairs):
  """t_min, t_max with each lane of `dead` given one of the dead `pairs`."""
  t_min, t_max = t_min.copy(), t_max.copy()
  pick = rng.integers(0, len(pairs), t_min.shape[0])
  for k, (lo, hi) in enumerate(pairs):
    at = dead & (pick == k)
    t_min[at], t_max[at] = lo, hi
  return t_min, t_max


@pytest.mark.parametrize("num_t,masked", [(36, False), (128, True)])
@settings(max_examples=10, deadline=None)
@given(dead=st.lists(st.booleans(), min_size=64, max_size=64), seed=st.integers(0, 2**16))
def test_plain_versions_on_dead_lanes_interleaved(num_t, masked, dead, seed):
  rng = np.random.default_rng(seed)
  v0, e1, e2, o, d, lo, hi = _soup(rng, num_t, 64)
  dead = np.asarray(dead)
  lo, hi = _interleave(rng, lo, hi, dead, DEAD)
  v0, e1, e2, o, d, lo, hi = (torch.from_numpy(x) for x in (v0, e1, e2, o, d, lo, hi))
  mask = torch.from_numpy(rng.uniform(size=num_t) > 0.3) if masked else None
  dead = torch.from_numpy(dead)
  assert torch.equal(brute_trace.dead_lanes(lo, hi), dead)
  hit = brute_trace.intersect_plain(v0, e1, e2, o, d, lo, hi, tri_mask=mask)
  occ = brute_trace.occluded_plain(v0, e1, e2, o, d, lo, hi, tri_mask=mask)
  live = ~dead
  alone = brute_trace.intersect_plain(v0, e1, e2, o[live], d[live], lo[live], hi[live],
                                      tri_mask=mask)
  for got, want in zip(hit, alone):
    assert torch.equal(got[live], want)
  assert torch.equal(occ[live], brute_trace.occluded_plain(
      v0, e1, e2, o[live], d[live], lo[live], hi[live], tri_mask=mask))
  # a dead lane gets the miss a plain miss gets: t = +inf, tri = -1, u = v = 0
  none = brute_trace.intersect_plain(v0[:0], e1[:0], e2[:0], o[dead], d[dead], lo[dead], hi[dead])
  for got, want in zip(hit, none):
    assert torch.equal(got[dead], want)
  assert not bool(occ[dead].any())
  assert torch.equal(occ, hit.found)


@pytest.mark.parametrize("num_t,masked,seed", [(36, False, 20), (128, True, 21)])
def test_dead_lanes_against_the_jax_package(num_t, masked, seed):
  rng = np.random.default_rng(seed)
  v0, e1, e2, o, d, lo, hi = _soup(rng, num_t, 2048)
  dead = rng.uniform(size=2048) < 0.5
  lo, hi = _interleave(rng, lo, hi, dead, EMPTY)
  mask = rng.uniform(size=num_t) > 0.3 if masked else np.ones(num_t, bool)
  j = [jnp.asarray(x) for x in (v0, e1, e2, o, d, lo, hi)]
  ref = jtrace.intersect_scan(*j, jnp.asarray(mask))
  jscene = types.SimpleNamespace(tri_v0=j[0], tri_e1=j[1], tri_e2=j[2], bvh=None)
  ref_occ = np.asarray(jtrace.trace_occluded(jscene, *j[3:], jnp.asarray(mask)))
  args = [torch.from_numpy(x) for x in (v0, e1, e2, o, d, lo, hi)]
  got = brute_trace.intersect_plain(*args, tri_mask=torch.from_numpy(mask))
  occ = brute_trace.occluded_plain(*args, tri_mask=torch.from_numpy(mask)).numpy()
  rtri, gtri = np.asarray(ref.tri), got.tri.numpy()
  # the dead lanes miss in both, exactly
  assert bool((rtri[dead] == -1).all()) and bool((gtri[dead] == -1).all())
  assert not ref_occ[dead].any() and not occ[dead].any()
  # the live lanes: the same triangle but where an edge or a tie flips it
  # under the reference's fused rounding, t within T_RTOL where it is the same
  live = ~dead
  same = rtri[live] == gtri[live]
  assert same.mean() >= 0.98 and (ref_occ[live] == occ[live]).mean() >= 0.98
  both = same & (gtri[live] >= 0)
  assert both.sum() >= 100
  np.testing.assert_allclose(got.t.numpy()[live][both], np.asarray(ref.t)[live][both],
                             rtol=T_RTOL, atol=1e-6)
