"""The port's Woop kernels K9a/K9b against the JAX package (CPU).

`etx_tracer_tpu_torch/ops/woop_trace.py` builds a (T, 12) table of Woop
rows (`woop_tables`) and evaluates the TPU kernels' arithmetic on it
(`intersect_plain`, `occluded_plain`). Here the table is held against
`pallas_trace._woop_tables` with the TPU's chunked matmul layout undone,
and the plain versions against the TPU kernels' own bodies,
`_kernel_woop` and `_kernel_woop_anyhit`, run through
`pl.pallas_call(interpret=True)` with the JAX wrapper's own tables and grid.

The JAX side forms w = A o + b and q = A d with one `dot_general` (its own
summation order) on a table whose rows may differ from the port's in the
last bit (`rsqrt`, the order of the bias sums); the port sums each product
in a fixed order. Near the edge of a triangle the Woop barycentrics are
small differences of terms of the size |A| |o|, so a rounding difference
moves them by about an ulp of those terms. Hit distances are compared to a
relative T_RTOL, and `tri` exactly on every ray that neither ties (two hits
within 1e-4) nor grazes: a ray grazes when some triangle's validity
changes as every test is moved by a float64 bound of that rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from etx_tracer_tpu.ops import pallas_trace as jpallas
from etx_tracer_tpu_torch.ops import brute2_trace, woop_trace
from tests.test_torch_trace import T_ATOL, T_RTOL, UV_ATOL, _grazing, _rays, _torch, _tris

torch.set_num_threads(1)

ROUNDING = 2e-6   # relative rounding bound of one float32 Woop term (~16 ulp)


def _jax_rows(v0, e1, e2, mask):
  """`_woop_tables` with its chunked (8, chunks * 6 * TC) layout undone into
  (T, 12) rows [r_u b_u r_v b_v r_w b_w], and the direction rows it also
  holds (rows 4-6 of the q groups), (T, 3, 3)."""
  tab = np.asarray(jpallas._woop_tables(*(jnp.asarray(x) for x in (v0, e1, e2)),
                                        None if mask is None else jnp.asarray(mask)))
  num_t = v0.shape[0]
  tc = min(jpallas._W_TC, tab.shape[1] // 6)
  groups = tab.reshape(8, -1, 6, tc).transpose(2, 0, 1, 3).reshape(6, 8, -1)[:, :, :num_t]
  rows = np.concatenate([groups[g, 0:4].T for g in range(3)], axis=1)
  return rows, groups


@pytest.mark.parametrize("masked", [False, True])
def test_woop_tables_match_jax(masked):
  rng = np.random.default_rng(30 + masked)
  v0, e1, e2 = _tris(rng, 700)
  e1[:5] = 0.0                     # degenerate: zero rows
  e1[5:10] *= np.float32(1e-5)     # |e1 x e2|^2 below 1e-18: zero rows
  e2[5:10] *= np.float32(1e-5)
  mask = rng.uniform(size=700) > 0.3 if masked else None
  want, groups = _jax_rows(v0, e1, e2, mask)
  got = woop_trace.woop_tables(*_torch(v0, e1, e2),
                               None if mask is None else torch.from_numpy(mask)).numpy()
  assert got.shape == (700, woop_trace.ROW) and got.dtype == np.float32
  zero = ~(want != 0.0).any(axis=1)
  np.testing.assert_array_equal(zero, ~(got != 0.0).any(axis=1))
  assert zero[:10].all() and (not masked or zero[~mask].all())
  # each row to a few ulps of its largest entry
  scale = np.abs(want).reshape(700, 3, 4).max(axis=2, keepdims=True)
  err = np.abs(got - want).reshape(700, 3, 4) / np.maximum(scale, 1e-30)
  assert err.max() <= ROUNDING, err.max()
  # the direction rows of the q groups are r_u, r_v, r_w; the rest is zero
  for g in range(3):
    np.testing.assert_array_equal(groups[3 + g, 4:7].T, want[:, 4 * g:4 * g + 3])
    assert not groups[3 + g, :4].any() and not groups[3 + g, 7].any()
    assert not groups[g, 4:].any()


def _interpret_woop(v0, e1, e2, o, d, t_min, t_max, mask):
  """The TPU kernels' bodies on the CPU: `_kernel_woop` and
  `_kernel_woop_anyhit` through pallas_call in interpret mode, with the
  wrappers' own tables and grid (BlockSpecs without a memory space)."""
  tab = jpallas._woop_tables(*(jnp.asarray(x) for x in (v0, e1, e2)),
                             None if mask is None else jnp.asarray(mask))
  rays, rp = jpallas._woop_rays(*(jnp.asarray(x) for x in (o, d, t_min, t_max)))
  grid = (rp // jpallas._W_RB,)
  tri_spec = pl.BlockSpec(tab.shape, lambda i: (0, 0))
  ray_spec = pl.BlockSpec((jpallas._W_RB, 8), lambda i: (i, 0))
  col_spec = pl.BlockSpec((jpallas._W_RB, 1), lambda i: (i, 0))

  def col(dt):
    return jax.ShapeDtypeStruct((rp, 1), dt)

  hit = pl.pallas_call(
      jpallas._kernel_woop, grid=grid, in_specs=[tri_spec, ray_spec],
      out_specs=[col_spec] * 4, interpret=True,
      out_shape=[col(jnp.float32), col(jnp.int32), col(jnp.float32), col(jnp.float32)],
  )(tab, rays)
  occ = pl.pallas_call(
      jpallas._kernel_woop_anyhit, grid=grid, in_specs=[tri_spec, ray_spec],
      out_specs=col_spec, out_shape=col(jnp.float32), interpret=True)(tab, rays)
  n = o.shape[0]
  return [np.asarray(x)[:n, 0] for x in hit], np.asarray(occ)[:n, 0] > 0.5


def _woop_hits(v0, e1, e2, o, d, t_min, t_max, mask, slack):
  """(R, T) Woop hit distances in float64 (inf where no hit), with every
  test moved outward (slack > 0) or inward (slack < 0) by `|slack|` times
  the magnitude of the float32 terms that make up its operands."""
  f = np.float64
  v0, e1, e2, o, d = (x.astype(f) for x in (v0, e1, e2, o, d))
  n = np.cross(e1, e2)
  det = np.sum(n * n, axis=1)
  good = (det > 1e-18) & mask
  inv = np.where(good, 1.0 / np.where(good, det, 1.0), 0.0)
  r = [np.cross(e2, n) * inv[:, None], np.cross(n, e1) * inv[:, None],
       n * np.sqrt(inv)[:, None]]
  b = [-np.sum(rk * v0, axis=1) for rk in r]
  w = [o @ rk.T + bk for rk, bk in zip(r, b)]
  q = [d @ rk.T for rk in r]
  mw = [np.abs(o) @ np.abs(rk).T + np.abs(bk) for rk, bk in zip(r, b)]
  mq = [np.abs(d) @ np.abs(rk).T for rk in r]
  e = abs(slack)
  sgn = 1.0 if slack > 0 else -1.0
  with np.errstate(divide="ignore", invalid="ignore"):
    t = -w[2] / np.where(q[2] != 0.0, q[2], 1.0)
    dt = e * (mw[2] + np.abs(t) * mq[2]) / np.abs(np.where(q[2] != 0.0, q[2], 1.0))
    u = w[0] + t * q[0]
    v = w[1] + t * q[1]
    du = e * (mw[0] + np.abs(t) * mq[0]) + np.abs(q[0]) * dt
    dv = e * (mw[1] + np.abs(t) * mq[1]) + np.abs(q[1]) * dt
    dt = dt + e * np.abs(t)
    ok = (good[None] & (np.abs(q[2]) > 1e-7 - sgn * e * mq[2])
          & (u >= -sgn * du) & (v >= -sgn * dv) & (u + v <= 1.0 + sgn * (du + dv))
          & (t >= t_min[:, None] - sgn * dt) & (t <= t_max[:, None] + sgn * dt))
  return np.where(ok, t, np.inf)


def _ties_and_grazing(v0, e1, e2, o, d, t_min, t_max, mask):
  hits = _woop_hits(v0, e1, e2, o, d, t_min, t_max, mask, 1e-12)
  srt = np.sort(hits, axis=1)
  with np.errstate(invalid="ignore"):
    tie = np.isfinite(srt[:, 1]) & (srt[:, 1] - srt[:, 0] <= 1e-4 * np.maximum(1.0, srt[:, 0]))
  loose = np.isfinite(_woop_hits(v0, e1, e2, o, d, t_min, t_max, mask, ROUNDING))
  strict = np.isfinite(_woop_hits(v0, e1, e2, o, d, t_min, t_max, mask, -ROUNDING))
  return tie, (loose != strict).any(axis=1)


def _dead_lanes_interleaved(t_min, t_max):
  """The rays with every other lane made dead as the kernels' skip test
  (`woop_trace.dead_lanes`) finds it, in turn: t_max = 0, t_max = -0, a NaN
  t_min, t_min one ulp above t_max."""
  t_min, t_max = t_min.copy(), t_max.copy()
  t_max[0::8] = 0.0
  t_max[2::8] = -0.0
  t_min[4::8] = np.nan
  t_min[6::8] = np.nextafter(t_max[6::8], np.float32(np.inf))
  return t_min, t_max


# the ids of the cases without dead lanes are those they had before the
# dead-lane cases came
@pytest.mark.parametrize("num_t,masked,seed,dead", [
    pytest.param(600, False, 32, False, id="600-False-32"),
    pytest.param(600, True, 33, False, id="600-True-33"),
    pytest.param(1100, False, 34, False, id="1100-False-34"),
    pytest.param(1100, True, 35, False, id="1100-True-35"),
    pytest.param(600, False, 38, True, id="600-False-38-dead-lanes"),
    pytest.param(1100, True, 39, True, id="1100-True-39-dead-lanes")])
def test_woop_plain_matches_tpu_kernel_body(num_t, masked, seed, dead):
  rng = np.random.default_rng(seed)
  v0, e1, e2 = _tris(rng, num_t)
  o, d, t_min, t_max = _rays(rng, v0, e2, 512)
  if dead:
    t_min, t_max = _dead_lanes_interleaved(t_min, t_max)
  mask = rng.uniform(size=num_t) > 0.3 if masked else None
  (rt, rtri, ru, rv), rocc = _interpret_woop(v0, e1, e2, o, d, t_min, t_max, mask)
  tmask = None if mask is None else torch.from_numpy(mask)
  rays = _torch(v0, e1, e2, o, d, t_min, t_max)
  got = woop_trace.intersect_plain(*rays, tri_mask=tmask)
  occ = woop_trace.occluded_plain(*rays, tri_mask=tmask).numpy()
  gtri = got.tri.numpy()
  tie, grazing = _ties_and_grazing(v0, e1, e2, o, d, t_min, t_max,
                                   np.ones(num_t, bool) if mask is None else mask)
  assert not ((gtri != rtri) & ~grazing & ~tie).any()
  assert not ((occ != rocc) & ~grazing).any()
  assert (gtri == rtri).mean() > 0.97
  f = (rtri >= 0) & (gtri == rtri)
  assert f.sum() >= 50
  np.testing.assert_allclose(got.t.numpy()[f], rt[f], rtol=T_RTOL, atol=T_ATOL)
  np.testing.assert_allclose(got.u.numpy()[f], ru[f], atol=UV_ATOL)
  np.testing.assert_allclose(got.v.numpy()[f], rv[f], atol=UV_ATOL)
  # misses as the TPU kernel writes them, and no ray with t_max in {-1, 0} hits
  miss = gtri < 0
  assert np.all(np.isinf(got.t.numpy()[miss])) and np.all(got.u.numpy()[miss] == 0.0)
  np.testing.assert_array_equal(np.isinf(rt), rtri < 0)
  assert np.all(gtri[t_max <= 0.0] == -1) and not occ[t_max <= 0.0].any()
  np.testing.assert_array_equal(occ, gtri >= 0)
  # a lane the kernels skip misses in the TPU kernel body and the plain
  # versions alike
  skipped = woop_trace.dead_lanes(torch.from_numpy(t_min), torch.from_numpy(t_max)).numpy()
  assert skipped[::2].all() == dead and (skipped.mean() >= 0.5) == dead
  assert np.all(rtri[skipped] == -1) and not rocc[skipped].any()
  assert np.all(gtri[skipped] == -1) and not occ[skipped].any()


def test_woop_agrees_with_the_pair_tile_kernel_away_from_edges():
  """Two formulations of one test: K9a's and K3's plain versions give the
  same triangle wherever no edge is grazed and no hit ties."""
  rng = np.random.default_rng(36)
  v0, e1, e2 = _tris(rng, 300)
  o, d, t_min, t_max = _rays(rng, v0, e2, 1024)
  args = _torch(v0, e1, e2, o, d, t_min, t_max)
  woop = woop_trace.intersect_plain(*args)
  mt = brute2_trace.intersect_plain(*args)
  full = np.ones(300, bool)
  tie, grazing = _ties_and_grazing(v0, e1, e2, o, d, t_min, t_max, full)
  # an eighth of the rays aim at edges and vertices
  clean = ~tie & ~grazing & ~_grazing(v0, e1, e2, o, d, t_min, t_max, full)
  assert clean.mean() > 0.8
  np.testing.assert_array_equal(woop.tri.numpy()[clean], mt.tri.numpy()[clean])
  f = clean & (mt.tri.numpy() >= 0)
  np.testing.assert_allclose(woop.t.numpy()[f], mt.t.numpy()[f], rtol=T_RTOL, atol=T_ATOL)


def test_woop_wrappers_run_the_plain_versions_on_cpu_and_count_no_launch():
  rng = np.random.default_rng(37)
  v0, e1, e2 = _tris(rng, 520)     # two chunks, the second ragged
  args = _torch(v0, e1, e2, *_rays(rng, v0, e2, 777))
  before = dict(woop_trace.launches)
  hit = woop_trace.intersect(*args)
  occ = woop_trace.occluded(*args)
  ref = woop_trace.intersect_plain(*args)
  assert all(torch.equal(a, b) for a, b in zip(hit, ref))
  assert torch.equal(occ, woop_trace.occluded_plain(*args)) and torch.equal(occ, ref.found)
  assert woop_trace.launches == before
  # the table, the ray tiles and the chunks: one tile of rays at a time
  # gives the same hits
  tab = woop_trace.woop_tables(*args[:3])
  part = woop_trace.closest_from_table(tab, *(x[:100] for x in args[3:]))
  assert all(torch.equal(a, b[:100]) for a, b in zip(part, ref))
