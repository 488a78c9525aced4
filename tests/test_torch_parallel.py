"""The port's sharded renderers (`parallel/mesh.py`) on gloo ranks on the
CPU, against its single-device renders (`test_torch_parallel_jax.py` holds
them against the JAX package).

Each launch spawns its ranks (a few seconds of imports each); the rank
functions live in the port, since a spawned rank imports the module of its
function and this one imports JAX. A band's pixel ids are the full film's,
so the sharded films equal the single-device ones but for the float order
of sums (rtol 1e-5 / atol 1e-6 for PT, 1e-4 / 1e-6 for VCM, whose splats
are all-reduced). VCM renders are compared uncapped (a cell over the cap
keeps photons by a hash of their position bits); a capped render is held
on its mean. Films of 11 rows leave the last band padded for 2, 3 and 4
ranks.
"""

import time

import numpy as np
import pytest
import torch

from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.models import vcm as pvcm
from etx_tracer_tpu_torch.parallel import mesh as pmesh
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.scene import cornell as pcornell

torch.set_num_threads(1)

FILM = (16, 11)          # PT: no rank count of 2-4 divides 11 rows
VCM_FILM = (16, 16)
SPP, POOL, MPL = 2, 4096, 4
PT_RTOL, PT_ATOL = 1e-5, 1e-6
VCM_RTOL, VCM_ATOL = 1e-4, 1e-6
CAPPED_MEAN_RTOL = 0.05
UNCAPPED = 1 << 20
TIMEOUT = 240.0


def _cornell(film, **kw):
  return pcornell.build_cornell_box(film_size=film, diffuse_only=True, max_path_length=MPL,
                                    **kw).build(device="cpu")


def _gloo(fn, world, *args):
  return pmesh.launch(fn, world, "gloo", ["cpu"] * world, TIMEOUT, args=args)


@pytest.fixture(scope="module")
def pt_scene():
  return _cornell(FILM)


@pytest.fixture(scope="module")
def pt_single(pt_scene):
  """The single-device pool render: (camera image, rays)."""
  scene, config = pt_scene
  sums, rays = ppt.render_samples_static(scene, config, 0, SPP, pool_size=POOL, device="cpu")
  return ppt.finalize_film(sums, SPP, FILM[0]).camera.numpy(), int(rays)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_sharded_pool_matches_single_device(pt_scene, pt_single, world):
  scene, config = pt_scene
  ranks = _gloo(pmesh.render_samples_job, world, scene, config, 0, SPP, POOL)
  assert [r["rank"] for r in ranks] == list(range(world))
  assert ranks[0]["table"].shape == (FILM[0] * FILM[1], 14)
  assert all(r["table"] is None for r in ranks[1:])
  assert sum(r["rays"] for r in ranks) == ranks[0]["rays_total"] > pt_single[1]
  sharded = ppt.finalize_film(ppt.FilmSums(torch.from_numpy(ranks[0]["table"])), SPP,
                              FILM[0]).camera.numpy()
  assert np.isfinite(sharded).all()
  np.testing.assert_allclose(sharded, pt_single[0], rtol=PT_RTOL, atol=PT_ATOL)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_sharded_iteration_matches_single_device(pt_scene, world):
  """Two iterations of render_iteration_sharded (one lane a pixel), resumed
  from a single-device film of one iteration (`shard_film`: each rank
  takes its padded band)."""
  scene, config = pt_scene
  fs = ppt.render_iteration(scene, config, pfilm.allocate(*FILM, "cpu"), 0, device="cpu")
  ranks = _gloo(pmesh.iterations_job, world, scene, config, 1, 2, None, fs)
  for it in range(1, 3):
    fs = ppt.render_iteration(scene, config, fs, it, device="cpu")
  film = ranks[0]["film"]
  assert film["camera"].shape == (FILM[1], FILM[0], 3) and int(film["iteration"]) == 3
  for name in ("camera", "variance_half", "normals", "albedo"):
    np.testing.assert_allclose(film[name], getattr(fs, name).numpy(), rtol=PT_RTOL,
                               atol=PT_ATOL, err_msg=name)


@pytest.fixture(scope="module")
def vcm_scene():
  return pcornell.build_cornell_box(film_size=VCM_FILM, diffuse_only=False,
                                    max_path_length=5).build(device="cpu")


def _vcm_single(scene, config, options):
  fs = pfilm.allocate(*VCM_FILM, "cpu")
  for it in range(2):
    fs = pvcm.render_iteration(scene, config, options, fs, it, device="cpu")
  return fs


@pytest.mark.parametrize("world", [2, 3])
def test_sharded_vcm_matches_single_device(vcm_scene, world):
  """Two uncapped iterations: splats all-reduced, vertices all-gathered
  (16 rows over 3 ranks pads one row)."""
  options = pvcm.VCMOptions(max_photons_per_cell=UNCAPPED)
  ranks = _gloo(pmesh.iterations_job, world, *vcm_scene, 0, 2, options)
  want = _vcm_single(*vcm_scene, options)
  film = ranks[0]["film"]
  for name in ("camera", "light"):
    np.testing.assert_allclose(film[name], getattr(want, name).numpy(), rtol=VCM_RTOL,
                               atol=VCM_ATOL, err_msg=name)
  assert np.abs(film["light"]).max() > 0


def test_sharded_capped_vcm_mean(vcm_scene):
  options = pvcm.VCMOptions()
  film = _gloo(pmesh.iterations_job, 3, *vcm_scene, 0, 2, options)[0]["film"]
  got = film["camera"] + film["light"]
  want = pfilm.result_image(_vcm_single(*vcm_scene, options)).numpy()
  assert np.isfinite(got).all()
  assert abs(got.mean() - want.mean()) <= CAPPED_MEAN_RTOL * abs(want.mean())


def test_dryrun_four_ranks():
  shape, rays = pmesh.dryrun(4)
  assert shape == (11, 16, 3) and rays > 0


def test_failing_or_late_ranks_fail_the_launch():
  """A rank that raises fails the launch within seconds, with its
  traceback; a launch past its timeout kills its ranks and fails."""
  t0 = time.perf_counter()
  with pytest.raises(RuntimeError, match="TypeError"):
    pmesh.launch(len, 2, "gloo", ["cpu", "cpu"], TIMEOUT)
  assert time.perf_counter() - t0 < 60
  t0 = time.perf_counter()
  with pytest.raises(RuntimeError, match="did not finish within"):
    pmesh.launch(pmesh._dryrun_rank, 2, "gloo", ["cpu", "cpu"], 0.5)
  assert time.perf_counter() - t0 < 60
  with pytest.raises(ValueError, match="one card a rank"):
    pmesh.launch(len, 2, "nccl", ["cuda:0", "cuda:0"], TIMEOUT)


def test_ranks_with_no_device_named_want_the_card(monkeypatch, tmp_path):
  """Naming gloo is not asking for the CPU: with no device named, `launch`
  and `make_mesh` put ranks on the cards, under either backend, and raise
  without one."""
  import torch.distributed as dist
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  for backend in pmesh.BACKENDS:
    with pytest.raises(RuntimeError, match="no CUDA device"):
      pmesh.launch(len, 2, backend, timeout=TIMEOUT)
  dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                          world_size=1)
  try:
    with pytest.raises(RuntimeError, match="no CUDA device"):
      pmesh.make_mesh()
    mesh = pmesh.make_mesh("cpu")
    assert mesh.device == torch.device("cpu") and mesh.backend == "gloo" and mesh.world == 1
  finally:
    dist.destroy_process_group()
