"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked `cuda` need an NVIDIA GPU and skip without one. They import
only torch, the port and `chip_smoke.py` (which imports no JAX either), so
they run on a machine without JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(`--noconftest` skips tests/conftest.py, which sets JAX up for the other
tests.) The kernels are built with -fmad=false and evaluate the plain
versions' expressions in the same order, so results must be bit-equal.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from etx_tracer_tpu_torch.models import path_tracing
from etx_tracer_tpu_torch.benchmarks import micro
from etx_tracer_tpu_torch.ops import _build, brute2_trace, brute_trace, bvh_build, bvh_trace
from etx_tracer_tpu_torch.ops import woop_trace
from etx_tracer_tpu_torch.render import film
from etx_tracer_tpu_torch.scene import bigscene, cornell, materials
from etx_tracer_tpu_torch.scene import types as scene_types

torch.set_num_threads(1)


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
  return torch.device("cuda")


def _case(rng, num_t, num_r, dev):
  v0 = rng.uniform(-1.0, 1.0, (num_t, 3)).astype(np.float32)
  e1 = rng.uniform(-0.6, 0.6, (num_t, 3)).astype(np.float32)
  e2 = rng.uniform(-0.6, 0.6, (num_t, 3)).astype(np.float32)
  o = rng.uniform(-2.0, 2.0, (num_r, 3)).astype(np.float32)
  d = rng.normal(size=(num_r, 3)).astype(np.float32)
  q = num_r // 8
  d[:q, 0] = 0.0
  axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
  d[q:2 * q] = axes[rng.integers(0, 6, q)]
  ti = rng.integers(0, num_t, q)
  d[2 * q:3 * q] = v0[ti] + rng.uniform(size=(q, 1)).astype(np.float32) * e2[ti] - o[2 * q:3 * q]
  d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-20)
  t_min = np.full(num_r, 1e-4, np.float32)
  t_max = np.full(num_r, 100.0, np.float32)
  t_max[3 * q:4 * q] = -1.0
  t_max[4 * q:5 * q] = rng.uniform(0.0, 2.0, q)
  return [torch.from_numpy(x).to(dev) for x in (v0, e1, e2, o, d, t_min, t_max)]


def test_library_path_follows_source_and_flags(monkeypatch):
  p1 = _build.library_path("brute_trace")
  assert p1.parent == _build.BUILD_DIR and p1.name.startswith("libbrute_trace-")
  assert _build.library_path("brute_trace") == p1
  monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
  assert _build.library_path("brute_trace") != p1
  assert set(_build.SOURCES) == {p.stem for p in _build.SRC_DIR.glob("*.cu")}


@pytest.mark.cuda
@pytest.mark.parametrize("num_t,masked", [(36, False), (36, True), (128, False), (1, False),
                                          (600, True), (1100, False)])
def test_intersect_kernel_matches_plain(cuda, num_t, masked):
  rng = np.random.default_rng(num_t + masked)
  args = _case(rng, num_t, 70001, cuda)
  mask = torch.from_numpy(rng.uniform(size=num_t) > 0.3).to(cuda) if masked else None
  before = brute_trace.launches["intersect"]
  hit = brute_trace.intersect(*args, tri_mask=mask)
  assert brute_trace.launches["intersect"] == before + 1
  ref = brute_trace.intersect_plain(*args, tri_mask=mask)
  for got, want in zip(hit, ref):
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
  assert 0.05 < hit.found.float().mean().item() < 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("num_t,masked", [(36, False), (128, True), (1100, True)])
def test_occluded_kernel_matches_plain(cuda, num_t, masked):
  rng = np.random.default_rng(100 + num_t)
  args = _case(rng, num_t, 70001, cuda)
  mask = torch.from_numpy(rng.uniform(size=num_t) > 0.3).to(cuda) if masked else None
  before = brute_trace.launches["occluded"]
  occ = brute_trace.occluded(*args, tri_mask=mask)
  assert brute_trace.launches["occluded"] == before + 1
  assert occ.dtype == torch.bool
  assert torch.equal(occ, brute_trace.occluded_plain(*args, tri_mask=mask))


@pytest.mark.cuda
def test_kernels_take_strided_rays(cuda):
  rng = np.random.default_rng(7)
  v0, e1, e2, o, d, t_min, t_max = _case(rng, 36, 4096, cuda)
  wide = torch.cat([o, d], dim=1)  # (R, 6): o and d are strided views
  hit = brute_trace.intersect(v0, e1, e2, wide[:, :3], wide[:, 3:], t_min, t_max)
  ref = brute_trace.intersect(v0, e1, e2, o, d, t_min, t_max)
  assert all(torch.equal(a, b) for a, b in zip(hit, ref))


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
  rng = np.random.default_rng(8)
  v0, e1, e2, o, d, t_min, t_max = _case(rng, 36, 256, cuda)
  with pytest.raises(ValueError, match="float32"):
    brute_trace.intersect(v0, e1, e2, o.double(), d, t_min, t_max)
  with pytest.raises(ValueError, match="on"):
    brute_trace.occluded(v0.cpu(), e1, e2, o, d, t_min, t_max)
  # any triangle count: 129 is above the dispatch's 128, not the kernel's limit
  args = _case(rng, 129, 256, cuda)
  assert all(torch.equal(a, b) for a, b in zip(brute_trace.intersect(*args),
                                                 brute_trace.intersect_plain(*args)))
  with pytest.raises(ValueError, match="shape"):
    brute_trace.occluded(v0, e1, e2, o, d, t_min[:-1], t_max)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_t", [1, 36, 128, 129, 1100, 15396])
def test_brute_kernels_on_mixed_lanes_match_plain(cuda, num_t, masked):
  rng = np.random.default_rng(700 + num_t + masked)
  args = _case(rng, num_t, 8193, cuda)
  mask = torch.from_numpy(rng.uniform(size=num_t) > 0.3).to(cuda) if masked else None
  tris = args[:3]
  # dead lanes (which K1/K2 skip) among live ones, intervals that are not
  # empty, strided rays: the patterns chip_smoke.py holds them on
  for label, rays in chip_smoke.lane_variants(args[3:]).items():
    hit = brute_trace.intersect(*tris, *rays, tri_mask=mask)
    occ = brute_trace.occluded(*tris, *rays, tri_mask=mask)
    ref = brute_trace.intersect_plain(*tris, *rays, tri_mask=mask)
    for got, want in zip(hit, ref):
      assert torch.equal(got, want), label
    assert torch.equal(occ, brute_trace.occluded_plain(*tris, *rays, tri_mask=mask)), label
    assert torch.equal(occ, hit.found), label
    assert not bool(hit.found[brute_trace.dead_lanes(rays[2], rays[3])].any()), label


@pytest.mark.cuda
@pytest.mark.parametrize("num_r", [300, 4096, 16384, 65536])
def test_brute_kernels_on_batches_of_every_width_match_plain(cuda, num_r):
  # a narrow batch runs small tiles and several lanes a ray; every other
  # ray is dead, so each tile packs half its rays
  rng = np.random.default_rng(800 + num_r)
  v0, e1, e2, o, d, t_min, t_max = _case(rng, 36, num_r, cuda)
  t_max[::2] = 0.0
  hit = brute_trace.intersect(v0, e1, e2, o, d, t_min, t_max)
  ref = brute_trace.intersect_plain(v0, e1, e2, o, d, t_min, t_max)
  for got, want in zip(hit, ref):
    assert torch.equal(got, want)
  assert torch.equal(brute_trace.occluded(v0, e1, e2, o, d, t_min, t_max),
                     brute_trace.occluded_plain(v0, e1, e2, o, d, t_min, t_max))
  blocks, tile = brute_trace.launch_shape(36, num_r, False)
  assert blocks >= 1 and tile in (8, 16, 32, 64, 128, 256)


@pytest.mark.cuda
def test_brute_kernels_replay_in_a_cuda_graph(cuda):
  rng = np.random.default_rng(14)
  args = _case(rng, 36, 70001, cuda)
  want = brute_trace.intersect(*args)
  want_occ = brute_trace.occluded(*args)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(2):
      brute_trace.intersect(*args)
      brute_trace.occluded(*args)
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    hit = brute_trace.intersect(*args)
    occ = brute_trace.occluded(*args)
  for _ in range(2):
    for x in (hit.t, hit.u, hit.v):
      x.fill_(-7.0)
    hit.tri.fill_(-7)
    occ.fill_(True)
    graph.replay()
    torch.cuda.synchronize()
    for got, expected in zip(hit, want):
      assert torch.equal(got, expected)
    assert torch.equal(occ, want_occ)


@pytest.mark.cuda
def test_small_render_goes_through_the_kernels_and_matches_cpu(cuda):
  for key in brute_trace.launches:
    brute_trace.launches[key] = 0
  builder = cornell.build_cornell_box(film_size=(16, 16), max_path_length=6)
  scene, config = builder.build(device=cuda)
  card = film.result_image(path_tracing.render(scene, config, iterations=2)).cpu().numpy()
  assert brute_trace.launches["intersect"] > 0 and brute_trace.launches["occluded"] > 0
  scene, config = builder.build(device="cpu")
  cpu = film.result_image(path_tracing.render(scene, config, iterations=2, device="cpu")).numpy()
  outliers = (np.abs(card - cpu) > 1e-4 + 1e-3 * np.abs(cpu)).any(axis=-1)
  assert outliers.mean() <= 0.02
  assert abs(card.mean() - cpu.mean()) <= 0.005 * cpu.mean()


def _materials_case(rng, num_r, dev):
  """The materials scene's 996 triangles and rays from inside the room."""
  arrays, _ = materials.build_materials_scene((16, 16)).arrays()
  tris = [torch.from_numpy(arrays[k]).to(dev) for k in ("tri_v0", "tri_e1", "tri_e2")]
  rays = _case(rng, 996, num_r, dev)[3:]
  rays[0] = rays[0] * 0.45 + torch.tensor([0.0, 1.0, 0.0], device=dev)
  return tris + rays


@pytest.mark.cuda
@pytest.mark.parametrize("num_t,masked", [(129, False), (996, True), (4096, False), (36, True),
                                          (5000, False)])
def test_pair_tile_kernels_match_plain(cuda, num_t, masked):
  rng = np.random.default_rng(200 + num_t)
  args = _materials_case(rng, 70001, cuda) if num_t == 996 else _case(rng, num_t, 70001, cuda)
  mask = torch.from_numpy(rng.uniform(size=num_t) > 0.3).to(cuda) if masked else None
  before = dict(brute2_trace.launches)
  hit = brute2_trace.intersect(*args, tri_mask=mask)
  occ = brute2_trace.occluded(*args, tri_mask=mask)
  assert brute2_trace.launches == {k: n + 1 for k, n in before.items()}
  ref = brute2_trace.intersect_plain(*args, tri_mask=mask)
  for got, want in zip(hit, ref):
    assert got.dtype == want.dtype and torch.equal(got, want)
  assert torch.equal(occ, brute2_trace.occluded_plain(*args, tri_mask=mask))
  assert torch.equal(occ, hit.found)
  assert 0.05 < hit.found.float().mean().item() < 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_t", [129, 996, 4096, 4097, 15396])
def test_pair_tile_kernels_on_mixed_lanes_match_plain(cuda, num_t, masked):
  rng = np.random.default_rng(400 + num_t + masked)
  args = _materials_case(rng, 8193, cuda) if num_t == 996 else _case(rng, num_t, 8193, cuda)
  mask = torch.from_numpy(rng.uniform(size=num_t) > 0.3).to(cuda) if masked else None
  tris = args[:3]
  # dead lanes (which the kernels skip) among live ones, intervals that are
  # not empty, strided rays: the patterns chip_smoke.py holds them on
  for label, rays in chip_smoke.lane_variants(args[3:]).items():
    hit = brute2_trace.intersect(*tris, *rays, tri_mask=mask)
    occ = brute2_trace.occluded(*tris, *rays, tri_mask=mask)
    ref = brute2_trace.intersect_plain(*tris, *rays, tri_mask=mask)
    for got, want in zip(hit, ref):
      assert torch.equal(got, want), label
    assert torch.equal(occ, brute2_trace.occluded_plain(*tris, *rays, tri_mask=mask)), label
    assert torch.equal(occ, hit.found), label
    assert not bool(hit.found[brute2_trace.dead_lanes(rays[2], rays[3])].any()), label


@pytest.mark.cuda
def test_pair_tile_kernels_reject_what_they_do_not_take(cuda):
  rng = np.random.default_rng(9)
  # any triangle count: 4097 is above the dispatch's 4096, not the kernel's limit
  args = _case(rng, 4097, 256, cuda)
  assert all(torch.equal(a, b) for a, b in zip(brute2_trace.intersect(*args),
                                                 brute2_trace.intersect_plain(*args)))
  v0, e1, e2, o, d, t_min, t_max = _case(rng, 200, 256, cuda)
  with pytest.raises(ValueError, match="contiguous"):
    brute2_trace.occluded(v0, e1, e2, o, d, t_min, torch.stack([t_max, t_max], 1)[:, 0])


@pytest.mark.cuda
def test_materials_render_goes_through_the_pair_tile_kernels_and_matches_cpu(cuda):
  for counts in (brute_trace.launches, brute2_trace.launches):
    for key in counts:
      counts[key] = 0
  builder = materials.build_materials_scene((16, 16))
  scene, config = builder.build(device=cuda)
  card = film.result_image(path_tracing.render(scene, config, iterations=2)).cpu().numpy()
  assert brute2_trace.launches["intersect"] > 0 and brute2_trace.launches["occluded"] > 0
  assert brute_trace.launches == {"intersect": 0, "occluded": 0}
  scene, config = builder.build(device="cpu")
  cpu = film.result_image(path_tracing.render(scene, config, iterations=2, device="cpu")).numpy()
  outliers = (np.abs(card - cpu) > 1e-4 + 1e-3 * np.abs(cpu)).any(axis=-1)
  assert outliers.mean() <= 0.02
  assert abs(card.mean() - cpu.mean()) <= 0.005 * abs(cpu.mean())


def _bvh_case(rng, which, num_r, dev):
  """(BVH, rays): bigscene's tree with rays from inside the room, the tree
  of a random 3000-triangle soup, or a comb 61 levels deep
  (`chip_smoke.comb_tree`), whose fat walk pushes 60 stack entries."""
  if which == "comb":
    tris, bvh = chip_smoke.comb_tree(rng, 61, dev)
    return bvh, chip_smoke.test_rays(rng, *tris, num_r, dev)
  if which == "bigscene":
    arrays, _ = bigscene.build_bigscene((16, 16)).arrays()
    rays = _case(rng, 36, num_r, dev)[3:]
    rays[0] = rays[0] * 0.45 + torch.tensor([0.0, 1.0, 0.0], device=dev)
  else:
    v0, e1, e2, *rays = _case(rng, 3000, num_r, dev)
    arrays = {"tri_v0": v0.cpu().numpy(), "tri_e1": e1.cpu().numpy(), "tri_e2": e2.cpu().numpy()}
    tree = bvh_build.build_bvh(arrays["tri_v0"], arrays["tri_e1"], arrays["tri_e2"])
    arrays.update({f"bvh.{k}": v for k, v in tree.items()})
  return scene_types.bvh_from_arrays(bvh_build.kernel_tables(arrays), dev), rays


_BVH_KERNELS = {"fat": ("intersect_fat", "occluded_fat"), "node": ("intersect_node", "occluded_node")}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["fat", "node"])
@pytest.mark.parametrize("which,masked", [("bigscene", False), ("soup", True)])
def test_bvh_kernels_match_plain(cuda, form, which, masked):
  rng = np.random.default_rng(300 + masked)
  bvh, rays = _bvh_case(rng, which, 70001, cuda)
  if form == "node":
    bvh = scene_types.without_fat_rows(bvh)
  num_t = bvh.prim_tris.shape[0]
  mask = torch.from_numpy(rng.uniform(size=num_t) > 0.3).to(cuda) if masked else None
  closest, occluded = _BVH_KERNELS[form]
  before = dict(bvh_trace.launches)
  hit = getattr(bvh_trace, closest)(bvh, *rays, tri_mask=mask)
  occ = getattr(bvh_trace, occluded)(bvh, *rays, tri_mask=mask)
  assert bvh_trace.launches == {k: n + (k in (closest, occluded)) for k, n in before.items()}
  ref = getattr(bvh_trace, f"{closest}_plain")(bvh, *rays, tri_mask=mask)
  for got, want in zip(hit, ref):
    assert got.dtype == want.dtype and torch.equal(got, want)
  assert torch.equal(occ, getattr(bvh_trace, f"{occluded}_plain")(bvh, *rays, tri_mask=mask))
  assert torch.equal(occ, hit.found)
  assert 0.05 < hit.found.float().mean().item() < 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("which", ["bigscene", "soup", "comb"])
@pytest.mark.parametrize("form", ["fat", "node"])
def test_bvh_kernels_on_mixed_lanes_match_plain(cuda, form, which, masked):
  rng = np.random.default_rng(500 + masked)
  bvh, rays = _bvh_case(rng, which, 8193, cuda)
  if form == "node":
    bvh = scene_types.without_fat_rows(bvh)
  num_t = bvh.prim_tris.shape[0]
  mask = torch.from_numpy(rng.uniform(size=num_t) > 0.3).to(cuda) if masked else None
  closest, occluded = _BVH_KERNELS[form]
  # dead lanes (empty intervals, which K5/K6 skip) among live ones,
  # intervals that are not empty, strided rays: the patterns chip_smoke.py
  # holds them on
  for label, lane_rays in chip_smoke.lane_variants(rays).items():
    hit = getattr(bvh_trace, closest)(bvh, *lane_rays, tri_mask=mask)
    occ = getattr(bvh_trace, occluded)(bvh, *lane_rays, tri_mask=mask)
    ref = getattr(bvh_trace, f"{closest}_plain")(bvh, *lane_rays, tri_mask=mask)
    for got, want in zip(hit, ref):
      assert torch.equal(got, want), label
    assert torch.equal(occ, getattr(bvh_trace, f"{occluded}_plain")(bvh, *lane_rays,
                                                                     tri_mask=mask)), label
    assert torch.equal(occ, hit.found), label
    assert not bool(hit.found[bvh_trace.dead_lanes(lane_rays[2], lane_rays[3])].any()), label


@pytest.mark.cuda
@pytest.mark.parametrize("num_r", [300, 70001])
def test_fat_kernels_back_to_back_on_one_stream_give_equal_outputs(cuda, num_r):
  # the second launch finds the ray queue's counter reset by its own entry
  rng = np.random.default_rng(600 + num_r)
  bvh, rays = _bvh_case(rng, "bigscene", num_r, cuda)
  hits = [bvh_trace.intersect_fat(bvh, *rays) for _ in range(2)]
  occs = [bvh_trace.occluded_fat(bvh, *rays) for _ in range(2)]
  torch.cuda.synchronize()
  ref = bvh_trace.intersect_fat_plain(bvh, *rays)
  for hit in hits:
    for got, want in zip(hit, ref):
      assert torch.equal(got, want)
  for occ in occs:
    assert torch.equal(occ, ref.found)


@pytest.mark.cuda
def test_fat_kernels_replay_in_a_cuda_graph(cuda):
  rng = np.random.default_rng(13)
  bvh, rays = _bvh_case(rng, "bigscene", 70001, cuda)
  want = bvh_trace.intersect_fat(bvh, *rays)
  want_occ = bvh_trace.occluded_fat(bvh, *rays)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(2):
      bvh_trace.intersect_fat(bvh, *rays)
      bvh_trace.occluded_fat(bvh, *rays)
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    hit = bvh_trace.intersect_fat(bvh, *rays)
    occ = bvh_trace.occluded_fat(bvh, *rays)
  for _ in range(2):
    for x in (hit.t, hit.u, hit.v):
      x.fill_(-7.0)
    hit.tri.fill_(-7)
    occ.fill_(True)
    graph.replay()
    torch.cuda.synchronize()
    for got, expected in zip(hit, want):
      assert torch.equal(got, expected)
    assert torch.equal(occ, want_occ)


@pytest.mark.cuda
def test_bvh_kernels_reject_what_they_do_not_take(cuda):
  rng = np.random.default_rng(10)
  bvh, (o, d, t_min, t_max) = _bvh_case(rng, "soup", 256, cuda)
  with pytest.raises(ValueError, match="float32"):
    bvh_trace.intersect_fat(bvh, o.double(), d, t_min, t_max)
  with pytest.raises(ValueError, match="shape"):
    bvh_trace.occluded_node(bvh, o, d, t_min[:-1], t_max)
  with pytest.raises(ValueError, match="contiguous"):
    bvh_trace.occluded_fat(bvh, o, d, t_min, torch.stack([t_max, t_max], 1)[:, 0])
  with pytest.raises(ValueError, match="on"):
    bvh_trace.intersect_node(scene_types.to_device(bvh, "cpu")._replace(prim_tris=bvh.prim_tris),
                             o, d, t_min, t_max)
  with pytest.raises(ValueError, match="no fat rows"):
    bvh_trace.intersect_fat(scene_types.without_fat_rows(bvh), o, d, t_min, t_max)
  with pytest.raises(ValueError, match="tri_mask"):
    bvh_trace.occluded_fat(bvh, o, d, t_min, t_max, tri_mask=torch.ones(3000, device=cuda))
  with pytest.raises(ValueError, match="tri_mask"):
    bvh_trace.intersect_node(bvh, o, d, t_min, t_max,
                             tri_mask=torch.ones(2999, dtype=torch.bool, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["fat", "node"])
def test_bigscene_render_goes_through_the_bvh_kernels_and_matches_cpu(cuda, form):
  for key in bvh_trace.launches:
    bvh_trace.launches[key] = 0
  builder = bigscene.build_bigscene((16, 16))

  def scene_on(dev):
    scene, config = builder.build(device=dev)
    if form == "node":
      scene = scene._replace(bvh=scene_types.without_fat_rows(scene.bvh))
    return scene, config

  card = film.result_image(path_tracing.render(*scene_on(cuda), iterations=2)).cpu().numpy()
  closest, occluded = _BVH_KERNELS[form]
  assert bvh_trace.launches[closest] > 0 and bvh_trace.launches[occluded] > 0
  assert sum(bvh_trace.launches.values()) == bvh_trace.launches[closest] + bvh_trace.launches[occluded]
  cpu = film.result_image(path_tracing.render(*scene_on("cpu"), iterations=2, device="cpu")).numpy()
  outliers = (np.abs(card - cpu) > 1e-4 + 1e-3 * np.abs(cpu)).any(axis=-1)
  assert outliers.mean() <= 0.02
  assert abs(card.mean() - cpu.mean()) <= 0.005 * cpu.mean()


@pytest.mark.cuda
@pytest.mark.parametrize("num_t,masked", [(129, False), (996, True), (1060, False),
                                          (4096, True), (5000, False)])
def test_woop_kernels_match_plain(cuda, num_t, masked):
  rng = np.random.default_rng(300 + num_t)
  args = _materials_case(rng, 70001, cuda) if num_t == 996 else _case(rng, num_t, 70001, cuda)
  mask = torch.from_numpy(rng.uniform(size=num_t) > 0.3).to(cuda) if masked else None
  before = dict(woop_trace.launches)
  hit = woop_trace.intersect(*args, tri_mask=mask)
  occ = woop_trace.occluded(*args, tri_mask=mask)
  assert woop_trace.launches == {k: n + 1 for k, n in before.items()}
  ref = woop_trace.intersect_plain(*args, tri_mask=mask)
  for got, want in zip(hit, ref):
    assert got.dtype == want.dtype and torch.equal(got, want)
  assert torch.equal(occ, woop_trace.occluded_plain(*args, tri_mask=mask))
  assert torch.equal(occ, hit.found)
  assert 0.05 < hit.found.float().mean().item() < 0.99


def _woop_matches_plain(tris, rays, mask=None, label=""):
  """K9a and K9b once each on `rays`: each launch counted once, and both
  bit-equal to their plain versions; returns the closest hits."""
  before = dict(woop_trace.launches)
  hit = woop_trace.intersect(*tris, *rays, tri_mask=mask)
  occ = woop_trace.occluded(*tris, *rays, tri_mask=mask)
  assert woop_trace.launches == {k: n + 1 for k, n in before.items()}, label
  ref = woop_trace.intersect_plain(*tris, *rays, tri_mask=mask)
  for got, want in zip(hit, ref):
    assert got.dtype == want.dtype and torch.equal(got, want), label
  assert torch.equal(occ, woop_trace.occluded_plain(*tris, *rays, tri_mask=mask)), label
  assert torch.equal(occ, hit.found), label
  return hit


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("num_t", [129, 996, 4096])
def test_woop_kernels_on_mixed_lanes_match_plain(cuda, num_t, masked):
  rng = np.random.default_rng(900 + num_t + masked)
  args = _materials_case(rng, 8193, cuda) if num_t == 996 else _case(rng, num_t, 8193, cuda)
  mask = torch.from_numpy(rng.uniform(size=num_t) > 0.3).to(cuda) if masked else None
  # dead lanes (which the kernels skip) among live ones, intervals that are
  # not empty, strided rays: the patterns chip_smoke.py holds them on
  for label, rays in chip_smoke.lane_variants(args[3:]).items():
    hit = _woop_matches_plain(args[:3], rays, mask, label)
    assert not bool(hit.found[woop_trace.dead_lanes(rays[2], rays[3])].any()), label


@pytest.mark.cuda
@pytest.mark.parametrize("num_r", [1, 31, 32, 33, 255, 257, 4096])
def test_woop_kernels_on_batches_of_every_width_match_plain(cuda, num_r):
  # a tile packs its live rays: every third ray is dead, and K9a takes the
  # live ones two a warp, so an odd count leaves a warp one ray
  rng = np.random.default_rng(1000 + num_r)
  args = _materials_case(rng, max(num_r, 64), cuda)
  rays = [x[:num_r].contiguous() for x in args[3:]]
  rays[3][::3] = 0.0
  _woop_matches_plain(args[:3], rays)


@pytest.mark.cuda
@pytest.mark.parametrize("num_t", [1, 1024, 1025])
def test_woop_kernels_where_the_staging_changes_match_plain(cuda, num_t):
  # 1024 rows are staged at once, with no barrier in the loops; 1025 take a
  # second chunk of one row; one triangle is padded to 32 rows
  rng = np.random.default_rng(1100 + num_t)
  args = _case(rng, num_t, 20001, cuda)
  for mask in (None, torch.from_numpy(rng.uniform(size=num_t) > 0.3).to(cuda)):
    _woop_matches_plain(args[:3], args[3:], mask)


@pytest.mark.cuda
def test_woop_kernels_replay_in_a_cuda_graph(cuda):
  rng = np.random.default_rng(15)
  args = _materials_case(rng, 70001, cuda)
  args[6][::4] = 0.0  # dead lanes, skipped
  want = woop_trace.intersect(*args)
  want_occ = woop_trace.occluded(*args)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    for _ in range(2):
      woop_trace.intersect(*args)
      woop_trace.occluded(*args)
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  before = dict(woop_trace.launches)
  with torch.cuda.graph(graph):
    hit = woop_trace.intersect(*args)
    occ = woop_trace.occluded(*args)
  assert woop_trace.launches == {k: n + 1 for k, n in before.items()}
  for _ in range(2):
    for x in (hit.t, hit.u, hit.v):
      x.fill_(-7.0)
    hit.tri.fill_(-7)
    occ.fill_(True)
    graph.replay()
    torch.cuda.synchronize()
    for got, expected in zip(hit, want):
      assert torch.equal(got, expected)
    assert torch.equal(occ, want_occ)
  assert torch.equal(want_occ, woop_trace.occluded_plain(*args))


@pytest.mark.cuda
def test_woop_kernels_take_strided_rays_and_reject_what_they_do_not_take(cuda):
  rng = np.random.default_rng(11)
  v0, e1, e2, o, d, t_min, t_max = _case(rng, 700, 4096, cuda)
  wide = torch.cat([o, d], dim=1)
  hit = woop_trace.intersect(v0, e1, e2, wide[:, :3], wide[:, 3:], t_min, t_max)
  ref = woop_trace.intersect(v0, e1, e2, o, d, t_min, t_max)
  assert all(torch.equal(a, b) for a, b in zip(hit, ref))
  with pytest.raises(ValueError, match="float32"):
    woop_trace.intersect(v0, e1, e2, o.double(), d, t_min, t_max)
  with pytest.raises(ValueError, match="shape"):
    woop_trace.occluded(v0, e1, e2, o, d, t_min[:-1], t_max)
  with pytest.raises(ValueError, match="tri_mask"):
    woop_trace.occluded(v0, e1, e2, o, d, t_min, t_max, tri_mask=torch.ones(700, device=cuda))


@pytest.mark.cuda
def test_micro_trace_brute_runs_the_dense_kernels_on_the_card(cuda):
  for counts in (brute2_trace.launches, woop_trace.launches):
    for key in counts:
      counts[key] = 0
  lines = micro.run("trace_brute", cuda, 4096)
  assert len(lines) == 12 and all(x.seconds > 0.0 for x in lines)
  # a warm chain and the timed ones, of n_iter steps each, on three scenes
  n_iter, reps = micro.CHAIN["cuda"]
  calls = 3 * n_iter * (1 + reps)
  assert brute2_trace.launches == {"intersect": calls, "occluded": calls}
  assert woop_trace.launches == {"intersect": calls, "occluded": calls}
  by = {x.label: x.result for x in lines}
  for name in micro.SCENES:
    k3, k9 = by[f"{name} brute2 closest"], by[f"{name} woop closest"]
    assert (k3.tri == k9.tri).float().mean().item() > 0.99
    assert torch.equal(by[f"{name} woop anyhit"], k9.found)
