"""The port's host helpers of its last slice against the JAX package (CPU):
`scene/save_mtl.save_materials` (the same text for the same builder, and a
round trip through the port's loader), `benchmarks/denoise_eval` (`ssim`
bit-equal, the protocol smoke-run at a tiny size), and the public helpers
that ported modules lacked: the blue-noise generator, the SPD library
writer, `rgb_to_xyz`, Wien's law, `lerp`, the sRGB transfer functions,
`orthonormalize`, `make_frame`, `scalar_image`, `is_zero` and
`unpack_material_rows`. Closed forms agree within 1e-6 relative; host
numpy code is bit-equal.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import denoise_eval as jdenoise
from etx_tracer_tpu.core import bluenoise as jbluenoise
from etx_tracer_tpu.core import math as jem
from etx_tracer_tpu.core import spectrum as jspectrum
from etx_tracer_tpu.render import images as jimages
from etx_tracer_tpu.render import spectral as jspx
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu.scene import obj_loader as jobj
from etx_tracer_tpu.scene import packed as jpacked
from etx_tracer_tpu.scene import save_mtl as jsave
from etx_tracer_tpu.scene import spectral_data as jsdata
from etx_tracer_tpu_torch.benchmarks import denoise_eval as pdenoise
from etx_tracer_tpu_torch.core import bluenoise as pbluenoise
from etx_tracer_tpu_torch.core import math as pem
from etx_tracer_tpu_torch.core import spectrum as pspectrum
from etx_tracer_tpu_torch.render import images as pimages
from etx_tracer_tpu_torch.render import spectral as pspx
from etx_tracer_tpu_torch.scene import cornell as pcornell
from etx_tracer_tpu_torch.scene import obj_loader as pobj
from etx_tracer_tpu_torch.scene import packed as ppacked
from etx_tracer_tpu_torch.scene import save_mtl as psave
from etx_tracer_tpu_torch.scene import spectral_data as psdata
from tests.test_torch_render import _jax_arrays
from tests.test_torch_shading import _jax_showcase, _port_showcase

RTOL = 1e-6


def _t(x):
  return torch.from_numpy(np.array(x))


def _builders(kind):
  """The same scene staged by each package's builder: (port, JAX)."""
  if kind == "cornell fog":
    kw = dict(film_size=(32, 24), spectral=True, fog_scattering=0.3, fog_g=0.2)
    return pcornell.build_cornell_box(**kw), jcornell.build_cornell_box(**kw)
  return _port_showcase(film_size=(16, 16), order=0), _jax_showcase(film_size=(16, 16), order=0)


@pytest.mark.parametrize("kind", ["cornell fog", "showcase"])
def test_save_materials_writes_jax_text(tmp_path, kind):
  """The same builder gives the JAX package's MTL text byte for byte; the
  port's loader reads it back to the materials, mediums and camera the
  JAX loader reads from it."""
  pb, jb = _builders(kind)
  p, j = str(tmp_path / "p.mtl"), str(tmp_path / "j.mtl")
  psave.save_materials(p, pb)
  jsave.save_materials(j, jb)
  text = open(p).read()
  assert text == open(j).read()
  assert "newmtl et::camera" in text and text.count("newmtl ") > 5
  loaded = pobj.ObjSceneLoader()
  loaded.load_materials(p)
  lb = loaded.b
  assert set(lb.material_names) == {n for n in pb.material_names if not n.startswith("et::")}
  for name, idx in lb.material_names.items():
    assert lb.materials[idx].cls == pb.materials[pb.material_names[name]].cls, name
  assert list(lb.medium_names) == list(pb.medium_names) and lb.film_size == pb.film_size
  # the camera block comes first and names a medium declared after it: the
  # JAX loader leaves the camera outside it too
  jloaded = jobj.ObjSceneLoader()
  jloaded.load_materials(p)
  assert lb.camera_medium == jloaded.b.camera_medium
  assert [dataclasses.astuple(m) for m in lb.materials] == [
      dataclasses.astuple(m) for m in jloaded.b.materials]


def test_ssim_is_jax_ssim():
  rng = np.random.default_rng(11)
  a = rng.uniform(0.0, 2.0, (20, 24, 3)).astype(np.float32)
  b = (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
  assert pdenoise.ssim(a, b) == jdenoise.ssim(a, b)
  assert pdenoise.ssim(a, b, data_range=1.0) == jdenoise.ssim(a, b, data_range=1.0)
  assert pdenoise.ssim(a, a) == pytest.approx(1.0)


def test_denoise_eval_smoke(capsys):
  """The protocol at 16x16 on the CPU: a 16-spp ground truth, 2 spp
  denoised at 1 and 2 levels, the JAX file's keys."""
  out = pdenoise.run("cpu", size=16, gt_spp=16, spps=(2,), levels=(1, 2))
  assert [r["spp"] for r in out] == [2]
  row = out[0]
  assert [d["atrous_levels"] for d in row["per_depth"]] == [1, 2]
  assert all(np.isfinite(d["mse"]) and 0.0 < d["ssim"] <= 1.0 for d in row["per_depth"])
  assert row["mse_noisy"] > 0.0 and '"best_mse_reduction_x_overall"' in capsys.readouterr().out


def test_blue_noise_generator_matches_jax():
  """The void-and-cluster generator at 16x16: the JAX package's ranks, a
  permutation of every rank once."""
  got = pbluenoise.generate_mask(16)
  np.testing.assert_array_equal(got, jbluenoise.generate_mask(16))
  ranks = np.sort((got.reshape(-1) * 256 - 0.5).round().astype(int))
  np.testing.assert_array_equal(ranks, np.arange(256))


def test_spd_library_files_equal_jax(tmp_path):
  got = psdata.write_spd_library(str(tmp_path / "p"))
  want = jsdata.write_spd_library(str(tmp_path / "j"))
  assert [os.path.relpath(g, tmp_path / "p") for g in got] == [
      os.path.relpath(w, tmp_path / "j") for w in want]
  for g, w in zip(got, want):
    assert open(g).read() == open(w).read(), g


def test_math_and_spectrum_helpers_match_jax():
  rng = np.random.default_rng(12)
  a, b = rng.normal(size=(64, 3)).astype(np.float32), rng.normal(size=(64, 3)).astype(np.float32)
  t = rng.uniform(size=(64, 1)).astype(np.float32)
  v = rng.uniform(-0.1, 1.2, (64, 3)).astype(np.float32)
  nrm = (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)
  J = jnp.asarray
  pairs = [
      (pem.lerp(_t(a), _t(b), _t(t)), jem.lerp(J(a), J(b), J(t))),
      (pem.gamma_to_linear(_t(v)), jem.gamma_to_linear(J(v))),
      (pem.linear_to_gamma(_t(v)), jem.linear_to_gamma(J(v))),
      (pem.orthonormalize(_t(nrm), _t(b)), jem.orthonormalize(J(nrm), J(b))),
      (pspectrum.rgb_to_xyz(_t(v)), jspectrum.rgb_to_xyz(J(v))),
  ]
  for got, want in pairs:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-7)
  frame = pem.make_frame(_t(a), _t(b), _t(nrm))
  np.testing.assert_array_equal(torch.stack(frame, dim=-2).numpy(),
                                np.asarray(jem.make_frame(J(a), J(b), J(nrm))))
  for kelvin in (2700.0, 5000.0, 6500.0):
    assert pspectrum.black_body_radiation_maximum_wavelength(kelvin) == \
        jspectrum.black_body_radiation_maximum_wavelength(kelvin)
  resp = np.abs(rng.normal(size=(64, 3))).astype(np.float32)
  resp[::4] = 0.0
  resp[1::4] = 1e-8
  np.testing.assert_array_equal(pspx.is_zero(_t(resp)).numpy(), np.asarray(jspx.is_zero(J(resp))))


def test_scalar_image_and_material_rows_match_jax():
  """`scalar_image` on the showcase's bank (images in use, none, and per-lane
  channels) and on a scene without images; `unpack_material_rows` reads the
  JAX package's columns."""
  pb, jb = _builders("showcase")
  pscene, _ = pb.build(device="cpu")
  jscene, _ = jb.build()
  arrays = _jax_arrays(jscene)
  rng = np.random.default_rng(13)
  n = 256
  img = rng.integers(-1, pscene.images.pixels.shape[0], n).astype(np.int32)
  uv = rng.uniform(size=(n, 2)).astype(np.float32)
  ch = rng.integers(0, 4, n).astype(np.int32)
  got = pimages.scalar_image(pscene, _t(img), _t(uv), _t(ch), 0.5)
  want = jimages.scalar_image(jscene, jnp.asarray(img), jnp.asarray(uv), jnp.asarray(ch), 0.5)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
  assert (got.numpy()[img < 0] == 0.5).all()
  plain, _ = pcornell.build_cornell_box(film_size=(8, 8)).build(device="cpu")
  np.testing.assert_array_equal(pimages.scalar_image(plain, _t(img), _t(uv), 2, 0.25).numpy(),
                                np.full(n, 0.25, np.float32))
  rows = arrays["mat_table"]
  got_rows = ppacked.unpack_material_rows(_t(rows))
  want_rows = jpacked.unpack_material_rows(jnp.asarray(rows))
  for name, x in want_rows._asdict().items():
    np.testing.assert_array_equal(getattr(got_rows, name).numpy(), np.asarray(x), err_msg=name)
