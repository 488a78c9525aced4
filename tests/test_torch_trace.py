"""The port's ray/triangle intersection against the JAX package (CPU).

The plain versions of the K1 (closest hit) and K2 (any hit) kernels in
`etx_tracer_tpu_torch/ops/brute_trace.py` are held against the JAX package's
CPU route, `trace.intersect_scan` and `trace.trace_occluded`, on the same
numpy inputs, and, above the 128-triangle unroll limit, against the TPU
kernels' bodies `pallas_trace._kernel` and `_kernel_anyhit` (their
`fori_loop` branch) in interpret mode. The plain versions of the K3 and K4 pair-tile kernels in
`ops/brute2_trace.py` are held against the TPU kernels' own bodies,
`pallas_trace._kernel_brute2` and `_kernel_brute2_anyhit`, run through
`pl.pallas_call(interpret=True)`, and against `intersect_scan`; the
dispatch above 4096 triangles takes the BVH kernels' plain versions
(tests/test_torch_bigscene.py holds those against the JAX package). The JAX
reference runs jitted, where XLA contracts products and sums into fused
multiply-adds while the port rounds each operation, so hit distances agree
to a relative 1e-5, not bit for bit, and `tri` is compared exactly wherever
the ray's two nearest hits are not tied and no edge is grazed.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from etx_tracer_tpu.ops import pallas_trace as jpallas
from etx_tracer_tpu.ops import trace as jtrace
from etx_tracer_tpu_torch.ops import brute2_trace, brute_trace, bvh_build, bvh_trace
from etx_tracer_tpu_torch.ops import trace as ptrace
from etx_tracer_tpu_torch.scene import materials as pmaterials
from etx_tracer_tpu_torch.scene import types as ptypes

torch.set_num_threads(1)

T_RTOL = 1e-5   # hit distance, relative (FMA contraction in the JAX reference)
T_ATOL = 1e-6   # hit distance, absolute (hits just past t_min)
UV_ATOL = 1e-4  # barycentrics, absolute (u, v in [0, 1])


def _tris(rng, n):
  v0 = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
  e1 = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
  e2 = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
  return v0, e1, e2


def _rays(rng, v0, e2, n):
  """Random rays, axis-parallel ones, rays aimed at triangle edges and
  vertices, and rays with t_max in {-1, 0}."""
  o = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
  d = rng.normal(size=(n, 3)).astype(np.float32)
  q = n // 8
  d[:q, 0] = 0.0            # parallel to the yz plane
  d[q:2 * q, 1] = 0.0       # parallel to the xz plane
  axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
  d[2 * q:3 * q] = axes[rng.integers(0, 6, q)]
  ti = rng.integers(0, v0.shape[0], q)
  s = rng.uniform(0.0, 1.0, (q, 1)).astype(np.float32)
  s[: q // 4] = 0.0
  d[3 * q:4 * q] = v0[ti] + s * e2[ti] - o[3 * q:4 * q]
  d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-20)
  t_min = np.full(n, 1e-4, np.float32)
  t_max = np.full(n, 100.0, np.float32)
  t_max[4 * q:4 * q + q // 2] = -1.0
  t_max[4 * q + q // 2:5 * q] = 0.0
  t_max[5 * q:6 * q] = rng.uniform(0.0, 2.0, q)
  return o, d, t_min, t_max


def _all_hits_at(v0, e1, e2, o, d, t_min, t_max, mask, slacks):
  """(R, T) hit distances (inf where no hit) in float64 for each slack in
  `slacks`, with each bound of the hit test moved outward by the slack
  (inward when negative), scaled up where a small determinant magnifies
  float32 rounding in u, v and t. The geometry is computed once."""
  v0, e1, e2, o, d = (x.astype(np.float64) for x in (v0, e1, e2, o, d))
  p = np.cross(d[:, None, :], e2[None])
  det = np.sum(p * e1[None], -1)
  inv = np.where(np.abs(det) > 1e-9, 1.0 / np.where(det == 0, 1.0, det), 0.0)
  tv = o[:, None, :] - v0[None]
  u = np.sum(tv * p, -1) * inv
  q = np.cross(tv, e1[None])
  v = np.sum(q * d[:, None, :], -1) * inv
  t = np.sum(q * e2[None], -1) * inv
  del p, tv, q
  base = (np.abs(det) > 1e-9) & mask[None]
  scale = 1.0 + 1e-2 / np.maximum(np.abs(det), 1e-9)
  t_scale = np.maximum(1.0, np.abs(t))
  out = []
  for slack in slacks:
    s = slack * scale
    st = s * t_scale
    ok = (base & (u >= -s) & (v >= -s) & (u + v <= 1 + s)
          & (t >= t_min[:, None] - st) & (t <= t_max[:, None] + st))
    out.append(np.where(ok, t, np.inf))
  return out


def _all_hits(v0, e1, e2, o, d, t_min, t_max, mask, slack=1e-6):
  """(R, T) hit distances (inf where no hit) in float64, with each bound of
  the hit test moved outward by `slack` (`_all_hits_at`)."""
  return _all_hits_at(v0, e1, e2, o, d, t_min, t_max, mask, (slack,))[0]


def _grazing(v0, e1, e2, o, d, t_min, t_max, mask):
  """Rays that pass within 1e-5 of an edge of some triangle or of an end of
  their interval: the hit test of that triangle may go either way."""
  loose, strict = _all_hits_at(v0, e1, e2, o, d, t_min, t_max, mask, (1e-5, -1e-5))
  return (np.isfinite(loose) != np.isfinite(strict)).any(axis=1)


def _jax_hit(v0, e1, e2, o, d, t_min, t_max, mask):
  return jtrace.intersect_scan(*(jnp.asarray(x) for x in (v0, e1, e2, o, d, t_min, t_max)),
                               jnp.asarray(mask))


def _torch(*xs):
  return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("num_t,masked,seed", [(36, False, 0), (36, True, 1), (128, False, 2),
                                               (128, True, 3), (7, True, 4)])
def test_intersect_plain_matches_jax_intersect_scan(num_t, masked, seed):
  rng = np.random.default_rng(seed)
  v0, e1, e2 = _tris(rng, num_t)
  o, d, t_min, t_max = _rays(rng, v0, e2, 4096)
  mask = rng.uniform(size=num_t) > 0.3 if masked else np.ones(num_t, bool)
  ref = _jax_hit(v0, e1, e2, o, d, t_min, t_max, mask)
  got = brute_trace.intersect_plain(*_torch(v0, e1, e2, o, d, t_min, t_max),
                                    tri_mask=torch.from_numpy(mask))
  rt, rtri = np.asarray(ref.t), np.asarray(ref.tri)
  gt, gtri = got.t.numpy(), got.tri.numpy()

  # rays near a tie (a second hit within 1e-4 of the first, as at a shared
  # edge) or grazing an edge may pick another triangle or miss
  hits = _all_hits(v0, e1, e2, o, d, t_min, t_max, mask)
  srt = np.sort(hits, axis=1)
  with np.errstate(invalid="ignore"):
    near_tie = np.isfinite(srt[:, 1]) & (srt[:, 1] - srt[:, 0] <= 1e-4 * np.maximum(1.0, srt[:, 0]))
  grazing = _grazing(v0, e1, e2, o, d, t_min, t_max, mask)
  edge = (rtri >= 0) != (gtri >= 0)
  assert not (edge & ~grazing).any(), "found/missed differs away from edges"
  clean = ~near_tie & ~grazing
  assert clean.mean() > 0.8
  np.testing.assert_array_equal(gtri[clean], rtri[clean])
  f = clean & (rtri >= 0)
  assert f.sum() >= 20
  np.testing.assert_allclose(gt[f], rt[f], rtol=T_RTOL, atol=T_ATOL)
  np.testing.assert_allclose(got.u.numpy()[f], np.asarray(ref.u)[f], atol=UV_ATOL)
  np.testing.assert_allclose(got.v.numpy()[f], np.asarray(ref.v)[f], atol=UV_ATOL)
  # misses: t = +inf, tri = -1, and no ray with t_max < 0 ever hits
  assert np.all(np.isinf(gt[gtri < 0])) and np.all(gt[gtri >= 0] <= t_max[gtri >= 0])
  assert np.all(gtri[t_max < 0] == -1)


@pytest.mark.parametrize("num_t,masked,seed", [(36, False, 10), (128, True, 11)])
def test_occluded_plain_matches_jax_trace_occluded(num_t, masked, seed):
  rng = np.random.default_rng(seed)
  v0, e1, e2 = _tris(rng, num_t)
  o, d, t_min, t_max = _rays(rng, v0, e2, 4096)
  mask = rng.uniform(size=num_t) > 0.3 if masked else np.ones(num_t, bool)
  jscene = types.SimpleNamespace(tri_v0=jnp.asarray(v0), tri_e1=jnp.asarray(e1),
                                 tri_e2=jnp.asarray(e2), bvh=None)
  ref = np.asarray(jtrace.trace_occluded(
      jscene, *(jnp.asarray(x) for x in (o, d, t_min, t_max)), jnp.asarray(mask)))
  got = brute_trace.occluded_plain(*_torch(v0, e1, e2, o, d, t_min, t_max),
                                   tri_mask=torch.from_numpy(mask)).numpy()
  # only a ray whose answer flips at an edge or an interval end may differ
  grazing = _grazing(v0, e1, e2, o, d, t_min, t_max, mask)
  assert not ((got != ref) & ~grazing).any()
  assert (got == ref).mean() > 0.95
  assert 0.05 < got.mean() < 0.95
  assert not got[t_max < 0].any()


def test_occluded_agrees_with_closest_hit():
  """Any hit == a closest hit exists, on the same plain arithmetic."""
  rng = np.random.default_rng(5)
  v0, e1, e2 = _tris(rng, 50)
  args = _torch(v0, e1, e2, *_rays(rng, v0, e2, 2048))
  occ = brute_trace.occluded_plain(*args)
  hit = brute_trace.intersect_plain(*args)
  assert torch.equal(occ, hit.found)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_versions_give_the_same_bits_at_every_chunk_width(monkeypatch, masked):
  """K1/K2's plain versions take chunks of triangles at once: a chunk of
  one triangle is the per-triangle loop, and every width gives its bits,
  exact ties (duplicated triangles) to the lowest index."""
  rng = np.random.default_rng(6 + masked)
  v0, e1, e2 = _tris(rng, 60)
  v0[40:50], e1[40:50], e2[40:50] = v0[:10], e1[:10], e2[:10]
  args = _torch(v0, e1, e2, *_rays(rng, v0, e2, 512))
  mask = torch.from_numpy(rng.uniform(size=60) > 0.3) if masked else None
  outs = []
  for pairs in (512, 512 * 7, 512 * 64, 1 << 14):
    monkeypatch.setattr(brute_trace, "_PAIRS", {"cpu": pairs, "cuda": pairs})
    hit = brute_trace.intersect_plain(*args, tri_mask=mask)
    outs.append(([x.view(torch.int32) for x in (hit.t, hit.u, hit.v)] + [hit.tri],
                 brute_trace.occluded_plain(*args, tri_mask=mask)))
  for got, occ in outs[1:]:
    assert all(torch.equal(g, w) for g, w in zip(got, outs[0][0]))
    assert torch.equal(occ, outs[0][1])
  tri = outs[0][0][3]
  dup = (tri >= 40) & (tri < 50)   # a duplicate wins only over a masked first
  assert not dup.any() if mask is None else not mask[tri[dup].long() - 40].any()


def test_dispatch_runs_plain_versions_on_cpu_and_counts_no_launch():
  rng = np.random.default_rng(6)
  v0, e1, e2 = _tris(rng, 36)
  o, d, t_min, t_max = _torch(*_rays(rng, v0, e2, 512))
  scene = types.SimpleNamespace(tri_v0=torch.from_numpy(v0), tri_e1=torch.from_numpy(e1),
                                tri_e2=torch.from_numpy(e2))
  before = dict(brute_trace.launches)
  hit = ptrace.trace_closest(scene, o, d, t_min, t_max)
  occ = ptrace.trace_occluded(scene, o, d, t_min, t_max)
  ref = ptrace.intersect_scan(scene.tri_v0, scene.tri_e1, scene.tri_e2, o, d, t_min, t_max)
  assert torch.equal(hit.tri, ref.tri) and torch.equal(occ, ref.found)
  assert brute_trace.launches == before


@pytest.mark.parametrize("query", ["closest", "occluded"])
def test_dispatch_above_128_triangles_raises(query):
  """Above the pair-tile kernels' 4096 triangles dispatch walks the scene's
  BVH: K5/K6's plain versions over the fat rows, K7/K8's without them (on
  the CPU, launching no kernel); a scene without a BVH raises rather than
  fall back to a brute-force loop."""
  rng = np.random.default_rng(7)
  v0, e1, e2 = _tris(rng, ptrace._BVH_PALLAS_MIN_TRIS + 1)
  o, d, t_min, t_max = _torch(*_rays(rng, v0, e2, 64))
  tree = bvh_build.build_bvh(v0, e1, e2)
  bvh = ptypes.bvh_from_arrays(bvh_build.kernel_tables(
      {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2, **{f"bvh.{k}": v for k, v in tree.items()}}),
      "cpu")
  assert bvh.fat_table is not None
  fn = ptrace.trace_closest if query == "closest" else ptrace.trace_occluded
  plains = {"closest": (bvh_trace.intersect_fat_plain, bvh_trace.intersect_node_plain),
            "occluded": (bvh_trace.occluded_fat_plain, bvh_trace.occluded_node_plain)}[query]
  before = (dict(brute_trace.launches), dict(brute2_trace.launches), dict(bvh_trace.launches))
  for tree_form, plain in zip((bvh, ptypes.without_fat_rows(bvh)), plains):
    scene = types.SimpleNamespace(tri_v0=torch.from_numpy(v0), tri_e1=torch.from_numpy(e1),
                                  tri_e2=torch.from_numpy(e2), bvh=tree_form)
    got, want = fn(scene, o, d, t_min, t_max), plain(tree_form, o, d, t_min, t_max)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) if query == "closest" \
        else torch.equal(got, want)
  assert (brute_trace.launches, brute2_trace.launches, bvh_trace.launches) == before
  scene = types.SimpleNamespace(tri_v0=torch.from_numpy(v0), tri_e1=torch.from_numpy(e1),
                                tri_e2=torch.from_numpy(e2), bvh=None)
  with pytest.raises(ValueError, match="no BVH"):
    fn(scene, o, d, t_min, t_max)


# ------------------------------------------------------- K3 / K4 (pair tile)


def _interpret_brute2(v0, e1, e2, o, d, t_min, t_max, mask):
  """The TPU kernels' bodies on the CPU: `_kernel_brute2` and
  `_kernel_brute2_anyhit` through pallas_call in interpret mode, with the
  wrappers' own tables and grid (BlockSpecs without a memory space)."""
  tab = jpallas._brute2_tables(*(jnp.asarray(x) for x in (v0, e1, e2)),
                               None if mask is None else jnp.asarray(mask))
  rays, rp = jpallas._brute2_rays(*(jnp.asarray(x) for x in (o, d, t_min, t_max)))
  grid = (rp // jpallas._B2_RB,)
  tri_spec = pl.BlockSpec(tab.shape, lambda i: (0, 0))
  ray_spec = pl.BlockSpec((jpallas._B2_RB, 8), lambda i: (i, 0))
  col_spec = pl.BlockSpec((jpallas._B2_RB, 1), lambda i: (i, 0))

  def col(dt):
    return jax.ShapeDtypeStruct((rp, 1), dt)

  hit = pl.pallas_call(
      jpallas._kernel_brute2, grid=grid, in_specs=[tri_spec, ray_spec],
      out_specs=[col_spec] * 4, interpret=True,
      out_shape=[col(jnp.float32), col(jnp.int32), col(jnp.float32), col(jnp.float32)],
  )(tab, rays)
  occ = pl.pallas_call(
      jpallas._kernel_brute2_anyhit, grid=grid, in_specs=[tri_spec, ray_spec],
      out_specs=col_spec, out_shape=col(jnp.float32), interpret=True)(tab, rays)
  n = o.shape[0]
  return [np.asarray(x)[:n, 0] for x in hit], np.asarray(occ)[:n, 0] > 0.5


@pytest.mark.parametrize("num_t,masked,seed", [(600, False, 20), (600, True, 21),
                                               (1100, False, 22), (1100, True, 23),
                                               (100, False, 25), (5000, True, 26)])
def test_brute2_plain_matches_tpu_kernel_body(num_t, masked, seed):
  rng = np.random.default_rng(seed)
  v0, e1, e2 = _tris(rng, num_t)
  o, d, t_min, t_max = _rays(rng, v0, e2, 512)
  mask = rng.uniform(size=num_t) > 0.3 if masked else None
  (rt, rtri, ru, rv), rocc = _interpret_brute2(v0, e1, e2, o, d, t_min, t_max, mask)
  tmask = None if mask is None else torch.from_numpy(mask)
  got = brute2_trace.intersect_plain(*_torch(v0, e1, e2, o, d, t_min, t_max), tri_mask=tmask)
  occ = brute2_trace.occluded_plain(*_torch(v0, e1, e2, o, d, t_min, t_max),
                                    tri_mask=tmask).numpy()
  gtri = got.tri.numpy()
  # a ray whose validity flips within float32 rounding (an edge or an
  # interval end grazed) may differ; no other
  grazing = _grazing(v0, e1, e2, o, d, t_min, t_max,
                     np.ones(num_t, bool) if mask is None else mask)
  assert not ((gtri != rtri) & ~grazing).any()
  assert not ((occ != rocc) & ~grazing).any()
  assert (gtri == rtri).mean() > 0.98
  f = (rtri >= 0) & (gtri == rtri)
  assert f.sum() >= 50
  np.testing.assert_allclose(got.t.numpy()[f], rt[f], rtol=T_RTOL, atol=T_ATOL)
  np.testing.assert_allclose(got.u.numpy()[f], ru[f], atol=UV_ATOL)
  np.testing.assert_allclose(got.v.numpy()[f], rv[f], atol=UV_ATOL)
  # misses as the TPU kernel writes them, and no ray with t_max in {-1, 0} hits
  miss = gtri < 0
  assert np.all(np.isinf(got.t.numpy()[miss])) and np.all(got.u.numpy()[miss] == 0.0)
  assert np.all(gtri[t_max <= 0.0] == -1) and not occ[t_max <= 0.0].any()
  np.testing.assert_array_equal(occ, gtri >= 0)


def test_brute2_plain_matches_intersect_scan_on_the_materials_scene():
  """The JAX package's CPU route at the materials scene's 996 triangles."""
  arrays, _ = pmaterials.build_materials_scene((16, 16)).arrays()
  v0, e1, e2 = (arrays[k] for k in ("tri_v0", "tri_e1", "tri_e2"))
  assert v0.shape == (996, 3)
  rng = np.random.default_rng(24)
  o, d, t_min, t_max = _rays(rng, v0, e2, 2048)
  o = (o * np.float32(0.45) + np.float32([0.0, 1.0, 0.0])).astype(np.float32)  # inside the room
  mask = np.ones(996, bool)
  ref = _jax_hit(v0, e1, e2, o, d, t_min, t_max, mask)
  got = brute2_trace.intersect_plain(*_torch(v0, e1, e2, o, d, t_min, t_max))
  rtri, gtri = np.asarray(ref.tri), got.tri.numpy()
  hits = _all_hits(v0, e1, e2, o, d, t_min, t_max, mask)
  srt = np.sort(hits, axis=1)
  with np.errstate(invalid="ignore"):
    near_tie = np.isfinite(srt[:, 1]) & (srt[:, 1] - srt[:, 0] <= 1e-4 * np.maximum(1.0, srt[:, 0]))
  clean = ~near_tie & ~_grazing(v0, e1, e2, o, d, t_min, t_max, mask)
  assert clean.mean() > 0.8
  np.testing.assert_array_equal(gtri[clean], rtri[clean])
  f = clean & (rtri >= 0)
  assert f.mean() > 0.4
  np.testing.assert_allclose(got.t.numpy()[f], np.asarray(ref.t)[f], rtol=T_RTOL, atol=T_ATOL)
  np.testing.assert_allclose(got.u.numpy()[f], np.asarray(ref.u)[f], atol=UV_ATOL)
  occ = brute2_trace.occluded_plain(*_torch(v0, e1, e2, o, d, t_min, t_max)).numpy()
  np.testing.assert_array_equal(occ, gtri >= 0)


@pytest.mark.parametrize("num_t", [ptrace._UNROLL_LIMIT + 1, 996, ptrace._BVH_PALLAS_MIN_TRIS])
def test_dispatch_takes_the_pair_tile_plain_versions_on_cpu(num_t):
  rng = np.random.default_rng(num_t)
  v0, e1, e2 = _tris(rng, num_t)
  o, d, t_min, t_max = _torch(*_rays(rng, v0, e2, 256))
  scene = types.SimpleNamespace(tri_v0=torch.from_numpy(v0), tri_e1=torch.from_numpy(e1),
                                tri_e2=torch.from_numpy(e2))
  before = (dict(brute_trace.launches), dict(brute2_trace.launches))
  hit = ptrace.trace_closest(scene, o, d, t_min, t_max)
  occ = ptrace.trace_occluded(scene, o, d, t_min, t_max)
  ref = brute2_trace.intersect_plain(scene.tri_v0, scene.tri_e1, scene.tri_e2,
                                     o, d, t_min, t_max)
  assert all(torch.equal(a, b) for a, b in zip(hit, ref))
  assert torch.equal(occ, ref.found)
  assert (brute_trace.launches, brute2_trace.launches) == before


# ------------------------------------------- K1 / K2 above the unroll limit


def _interpret_brute(v0, e1, e2, o, d, t_min, t_max, mask):
  """The TPU kernels `_kernel` and `_kernel_anyhit` on the CPU through
  pallas_call in interpret mode, with `intersect_pallas`'s own table, ray
  planes and grid (BlockSpecs without a memory space). Above 128 triangles
  their triangle loop is a `fori_loop`."""
  num_t, num_r = v0.shape[0], o.shape[0]
  m = np.ones(num_t, np.float32) if mask is None else mask.astype(np.float32)
  tab = np.concatenate([v0, e1, e2, m[:, None], np.zeros((num_t, 6), np.float32)], axis=1)
  tab = np.concatenate([tab, np.zeros(((-num_t) % jpallas._SUBLANES, 16), np.float32)])
  tile = jpallas._RB * jpallas._LANES
  assert num_r % tile == 0
  g = num_r // jpallas._LANES
  planes = [jnp.asarray(np.ascontiguousarray(x).reshape(g, jpallas._LANES))
            for x in (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_min, t_max)]
  ray_spec = pl.BlockSpec((jpallas._RB, jpallas._LANES), lambda i: (i, 0))
  tri_spec = pl.BlockSpec(tab.shape, lambda i: (0, 0))
  grid = (g // jpallas._RB,)

  def plane(dt):
    return jax.ShapeDtypeStruct((g, jpallas._LANES), dt)

  hit = pl.pallas_call(
      jpallas._kernel, grid=grid, in_specs=[tri_spec] + [ray_spec] * 8,
      out_specs=[ray_spec] * 4, interpret=True,
      out_shape=[plane(jnp.float32), plane(jnp.int32), plane(jnp.float32), plane(jnp.float32)],
  )(jnp.asarray(tab), *planes)
  occ = pl.pallas_call(
      jpallas._kernel_anyhit, grid=grid, in_specs=[tri_spec] + [ray_spec] * 8,
      out_specs=ray_spec, out_shape=plane(jnp.float32), interpret=True,
  )(jnp.asarray(tab), *planes)
  return [np.asarray(x).reshape(num_r) for x in hit], np.asarray(occ).reshape(num_r) > 0.5


@pytest.mark.parametrize("masked,seed", [(False, 27), (True, 28)])
def test_brute_plain_matches_tpu_kernel_body_above_the_unroll_limit(masked, seed):
  """K1/K2's plain versions at 300 triangles against the TPU kernels'
  `fori_loop` branch."""
  rng = np.random.default_rng(seed)
  num_t = 300
  v0, e1, e2 = _tris(rng, num_t)
  o, d, t_min, t_max = _rays(rng, v0, e2, jpallas._RB * jpallas._LANES)
  mask = rng.uniform(size=num_t) > 0.3 if masked else None
  (rt, rtri, ru, rv), rocc = _interpret_brute(v0, e1, e2, o, d, t_min, t_max, mask)
  tmask = None if mask is None else torch.from_numpy(mask)
  got = brute_trace.intersect_plain(*_torch(v0, e1, e2, o, d, t_min, t_max), tri_mask=tmask)
  occ = brute_trace.occluded_plain(*_torch(v0, e1, e2, o, d, t_min, t_max),
                                   tri_mask=tmask).numpy()
  gtri = got.tri.numpy()
  grazing = _grazing(v0, e1, e2, o, d, t_min, t_max,
                     np.ones(num_t, bool) if mask is None else mask)
  assert not ((gtri != rtri) & ~grazing).any()
  assert not ((occ != rocc) & ~grazing).any()
  assert (gtri == rtri).mean() > 0.98
  f = (rtri >= 0) & (gtri == rtri)
  assert f.sum() >= 200
  np.testing.assert_allclose(got.t.numpy()[f], rt[f], rtol=T_RTOL, atol=T_ATOL)
  np.testing.assert_allclose(got.u.numpy()[f], ru[f], atol=UV_ATOL)
  np.testing.assert_allclose(got.v.numpy()[f], rv[f], atol=UV_ATOL)
  assert np.all(gtri[t_max <= 0.0] == -1) and not occ[t_max <= 0.0].any()
  np.testing.assert_array_equal(occ, gtri >= 0)


@pytest.mark.parametrize("num_t,route", [(128, "brute"), (129, "pair_tile"),
                                         (4096, "pair_tile"), (4097, "bvh")])
def test_dispatch_routes_by_the_jax_thresholds(num_t, route):
  """The kernels take any triangle count; the dispatch still routes by the
  JAX package's thresholds: K1/K2 up to 128, K3/K4 up to 4096, K5/K6 (K7/K8
  without fat rows) beyond."""
  rng = np.random.default_rng(num_t)
  v0, e1, e2 = _tris(rng, num_t)
  tree = bvh_build.build_bvh(v0, e1, e2)
  bvh = ptypes.bvh_from_arrays(bvh_build.kernel_tables(
      {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2, **{f"bvh.{k}": v for k, v in tree.items()}}),
      "cpu")
  want = {"brute": (brute_trace.intersect, brute_trace.occluded),
          "pair_tile": (brute2_trace.intersect, brute2_trace.occluded),
          "bvh": (bvh_trace.intersect_fat, bvh_trace.occluded_fat)}[route]
  for tree_form in (bvh, ptypes.without_fat_rows(bvh)):
    scene = types.SimpleNamespace(tri_v0=torch.from_numpy(v0), tri_e1=torch.from_numpy(e1),
                                  tri_e2=torch.from_numpy(e2), bvh=tree_form)
    closest, occluded = ptrace._route(scene)
    if route == "bvh" and tree_form.fat_table is None:
      want = (bvh_trace.intersect_node, bvh_trace.occluded_node)
    assert (closest.func, occluded.func) == want


def test_ray_sort_keys_and_permutation_equal_jax():
  """`_ray_sort_keys` gives the JAX package's 30-bit keys (as int64), and
  the stable sort its permutation, on the same numpy tree."""
  rng = np.random.default_rng(29)
  v0, e1, e2 = _tris(rng, 700)
  tree = bvh_build.build_bvh(v0, e1, e2)
  bvh = ptypes.bvh_from_arrays(bvh_build.kernel_tables(
      {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2, **{f"bvh.{k}": v for k, v in tree.items()}}),
      "cpu")
  jbvh = types.SimpleNamespace(node_min=jnp.asarray(tree["node_min"]),
                               node_max=jnp.asarray(tree["node_max"]))
  o, d, t_min, t_max = _rays(rng, v0, e2, 4096)
  o[:64] = o[64:128]                                  # equal keys: the order must hold
  o[128:160] = np.float32([[5.0, -5.0, 0.0]])         # outside the box: clipped
  want = np.asarray(jtrace._ray_sort_keys(jbvh, jnp.asarray(o), jnp.asarray(d)))
  got = ptrace._ray_sort_keys(bvh, *_torch(o, d))
  assert got.dtype == torch.int64 and want.dtype == np.uint32
  np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
  assert got.max().item() < 1 << 30
  (jo, jd, jt0, jt1), jinv = jtrace._sorted_for_trace(
      jbvh, *(jnp.asarray(x) for x in (o, d, t_min, t_max)))
  (po, pd, pt0, pt1), pinv = ptrace._sorted_for_trace(bvh, *_torch(o, d, t_min, t_max))
  np.testing.assert_array_equal(pinv.numpy(), np.asarray(jinv))
  for g, w in ((po, jo), (pd, jd), (pt0, jt0), (pt1, jt1)):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  np.testing.assert_array_equal(po[pinv].numpy(), o)
