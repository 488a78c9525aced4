"""The port's materials slice against the JAX package (CPU).

The materials showcase (`benchmarks/scenes.py:materials`: the Cornell box
with its conductor tall box, a rough gold, a glass and a thin-film sphere,
996 triangles, spectral) and the modules it brings: spectral mode, the
Fresnel and microfacet helpers, the energy-compensation tables, the
Conductor, Dielectric and Thinfilm lobes, and the masked dispatch over them.

Both packages get the same inputs, made from numpy seeds. Scene tables and
the numpy energy tables are built by the same numpy code on both sides and
must be equal. Module outputs are held to the JAX package run eagerly (one
XLA operation at a time), which differs from the port only in its
transcendental functions and summation order: values agree within
MODULE_RTOL relative and MODULE_ATOL absolute. A lane whose sampled lobe
depends on a comparison with a Fresnel term (reflect or refract) may take
the other branch when the two sides round that term differently, so at most
LANE_FLIP of the lanes may disagree. The whole render is held against the
JAX package's jitted render pixel by pixel, at the tolerances
tests/test_torch_render.py holds the Cornell render to.
"""

import dataclasses

import chip_smoke
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import scenes as jscenes
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.core import spectrum as jspec
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.render import emitters as jemitters
from etx_tracer_tpu.render import spectral as jspx
from etx_tracer_tpu.render.bsdf import common as jmf
from etx_tracer_tpu.render.bsdf import dispatch as jdispatch
from etx_tracer_tpu.render.bsdf import energy_lut as jlut
from etx_tracer_tpu.render.bsdf import lobes as jlobes
from etx_tracer_tpu.scene import ior as jior
from etx_tracer_tpu.scene import packed as jpacked
from etx_tracer_tpu_torch import scene_bridge
from etx_tracer_tpu_torch.core import spectrum as pspec
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.ops import brute2_trace
from etx_tracer_tpu_torch.render import emitters as pemitters
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.render import spectral as pspx
from etx_tracer_tpu_torch.render.bsdf import common as pmf
from etx_tracer_tpu_torch.render.bsdf import dispatch as pdispatch
from etx_tracer_tpu_torch.render.bsdf import energy_lut as plut
from etx_tracer_tpu_torch.render.bsdf import lobes as plobes
from etx_tracer_tpu_torch.scene import ior as pior
from etx_tracer_tpu_torch.scene import materials as pmaterials
from etx_tracer_tpu_torch.scene import packed as ppacked
from etx_tracer_tpu_torch.scene import types as ptypes
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

FILM, SPP, POOL = (16, 16), 2, 256   # the whole-render comparison
MODULE_RTOL = 1e-4                   # eager JAX vs the port, per module
MODULE_ATOL = 1e-5
LANE_FLIP = 0.005                    # lanes that may take the other lobe branch
OUTLIER_FRACTION = 0.02              # whole render: pixels off by > 1e-4 + 1e-3 |ref|
MEAN_RTOL = 0.005                    # whole render: image mean


def _t(x):
  return torch.from_numpy(np.array(x))


def _jax_arrays(scene):
  out = {}
  for name, v in scene._asdict().items():
    if name == "spec_at_wl":
      continue
    if isinstance(v, tuple):
      out.update({f"{name}.{f}": np.asarray(x) for f, x in v._asdict().items()
                  if x is not None})
    else:
      out[name] = np.asarray(v)
  return out


@pytest.fixture(scope="module")
def jax_scenes():
  """{spectral: (JAX DeviceScene, SceneConfig)} of the 16x16 materials scene,
  the BVH built by the JAX package's numpy builder (its native one turned
  off), which the port copies."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    return {s: jscenes.materials(FILM, spectral=s).build() for s in (True, False)}


@pytest.fixture(scope="module")
def port_scenes():
  return {s: pmaterials.build_materials_scene(FILM, spectral=s).build(device="cpu")
          for s in (True, False)}


@pytest.fixture(scope="module")
def jax_render(jax_scenes):
  scene, config = jax_scenes[True]
  sums, rays = jpt.render_samples_static(scene, config, 0, SPP, pool_size=POOL)
  fs = jpt.finalize_film(sums, SPP, config.film_width)
  return np.asarray(fs.camera + fs.light), np.asarray(sums.table), float(rays)


@pytest.fixture(scope="module")
def port_render(port_scenes):
  scene, config = port_scenes[True]
  sums, rays = ppt.render_samples_static(scene, config, 0, SPP, pool_size=POOL, device="cpu")
  fs = ppt.finalize_film(sums, SPP, config.film_width)
  return pfilm.result_image(fs).numpy(), sums.table.numpy(), int(rays)


def _close(got, want, what, rtol=MODULE_RTOL, atol=MODULE_ATOL):
  np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                             rtol=rtol, atol=atol, err_msg=what)


# ------------------------------------------------------------------- tables


@pytest.mark.parametrize("spectral", [True, False])
def test_materials_tables_equal_jax(jax_scenes, spectral):
  arrays, config = pmaterials.build_materials_scene(FILM, spectral=spectral).arrays()
  want = _jax_arrays(jax_scenes[spectral][0])
  assert set(arrays) <= set(want)
  for name in arrays:
    got = np.asarray(arrays[name])
    assert got.dtype == want[name].dtype and got.shape == want[name].shape, name
    np.testing.assert_array_equal(got, want[name], err_msg=name)
  jconfig = jax_scenes[spectral][1]
  for f in dataclasses.fields(ptypes.SceneConfig):
    assert getattr(config, f.name) == getattr(jconfig, f.name), f.name
  assert arrays["tri_v0"].shape == (996, 3) and arrays["spec_values"].shape == (15, 441)
  assert config.material_classes == (0, 3, 4, 5) and config.spectral == spectral


def test_scene_bridge_accepts_the_materials_scene(jax_scenes, port_scenes):
  jscene, jconfig = jax_scenes[True]
  scene, config = scene_bridge.from_numpy(_jax_arrays(jscene), dataclasses.asdict(jconfig),
                                          device="cpu")
  want, want_config = port_scenes[True]
  assert config == want_config
  # host facts, not tensors: the thin-film sphere's film
  assert scene.material_features == want.material_features == ("thinfilm",)
  for f in ptypes.DeviceScene._fields:
    if f == "material_features":
      continue
    got_t, want_t = getattr(scene, f), getattr(want, f)
    for g, w in zip(got_t if isinstance(got_t, tuple) else [got_t],
                    want_t if isinstance(want_t, tuple) else [want_t]):
      assert (g is None and w is None) or torch.equal(g, w), f


_SPD = """#class: conductor
#title: test metal
# wavelength (um) eta k
0.35 1.20 2.10
0.50 0.90 2.60
0.62 0.40 3.10
0.80 0.20 4.80
"""


@pytest.mark.parametrize("name", ["Au", "silver", "copper", "aluminum", "nickel", "brass",
                                  "glass", "water", "diamond", "vacuum", "testmetal"])
def test_ior_database_matches_jax(tmp_path, name):
  """Lorentz-Drude metals, the coarse conductor tables, the Cauchy
  dielectrics and an .spd file (micrometre wavelengths, scaled to nm)."""
  (tmp_path / "testmetal.spd").write_text(_SPD)
  got = pior.IORDatabase(str(tmp_path)).find(name)
  want = jior.IORDatabase(str(tmp_path)).find(name)
  assert got[0] == want[0]
  for g, w in zip(got[1:], want[1:]):
    assert g.cls == w.cls
    np.testing.assert_array_equal(g.values, w.values)


def test_ior_database_illuminants_are_a_later_slice():
  """The illuminant names, which the shading slice brought, resolve to the
  JAX package's spectra (tests/test_torch_shading.py holds each model)."""
  for name in ("d65", "daylight_6500k_noon_sky", "led_2700k_warm_white"):
    got, want = pior.IORDatabase().find(name), jior.IORDatabase().find(name)
    assert got[0] == want[0] and got[2] is None and want[2] is None
    np.testing.assert_array_equal(got[1].values, want[1].values)
  assert pior.IORDatabase().find("no-such-material") is None


def test_energy_tables_equal_jax():
  """The numpy table builders are copies: exact equality."""
  for got, want in zip(plut._tables_np(), jlut._tables_np()):
    np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(plut._dielectric_tables_np(), jlut._dielectric_tables_np())


def test_energy_lookups_match_jax():
  rng = np.random.default_rng(30)
  n = 4096
  mu = rng.uniform(-0.05, 1.05, n).astype(np.float32)
  alpha = np.exp(rng.uniform(np.log(5e-4), np.log(1.5), n)).astype(np.float32)
  eta = np.exp(rng.uniform(-1.1, 1.1, n)).astype(np.float32)
  _close(plut.e_lookup(_t(mu), _t(alpha)), jlut.e_lookup(jnp.asarray(mu), jnp.asarray(alpha)),
         "e_lookup", atol=1e-6)
  _close(plut.e_avg_lookup(_t(alpha)), jlut.e_avg_lookup(jnp.asarray(alpha)), "e_avg",
         atol=1e-6)
  _close(plut.e_dielectric_lookup(_t(mu), _t(alpha), _t(eta)),
         jlut.e_dielectric_lookup(jnp.asarray(mu), jnp.asarray(alpha), jnp.asarray(eta)),
         "e_dielectric", atol=1e-6)
  _close(plut.dielectric_compensation(_t(mu), _t(alpha), _t(eta)),
         jlut.dielectric_compensation(jnp.asarray(mu), jnp.asarray(alpha), jnp.asarray(eta)),
         "dielectric_compensation")


# ------------------------------------------------------------- spectral mode


def test_spectral_helpers_match_jax(port_scenes, jax_scenes):
  rng = np.random.default_rng(31)
  n = 4096
  rnd = rng.uniform(size=n).astype(np.float32)
  rnd[:3] = [0.0, 0.5, 1.0 - 2 ** -24]
  wl = np.asarray(jspec.sample_wavelength(jnp.asarray(rnd)))
  _close(pspec.sample_wavelength(_t(rnd)), wl, "sample_wavelength", rtol=1e-6, atol=1e-3)
  assert wl.min() >= 390.0 and wl.max() <= 830.0
  _close(pspec.sampling_pdf(_t(wl)), jspec.sampling_pdf(jnp.asarray(wl)), "sampling_pdf")
  _close(pspec.xyz_bar(_t(wl)), jspec.xyz_bar(jnp.asarray(wl)), "xyz_bar")
  value = rng.uniform(0.0, 3.0, n).astype(np.float32)
  wl_out = wl.copy()
  wl_out[:8] = [380.0, 389.9, 830.1, 900.0, 390.0, 830.0, -1.0, 0.0]
  _close(pspec.spectral_to_xyz(_t(value), _t(wl_out)),
         jspec.spectral_to_xyz(jnp.asarray(value), jnp.asarray(wl_out)), "spectral_to_xyz")
  _close(pspx.to_film_rgb(_t(value[:, None]), _t(wl), True),
         jspx.to_film_rgb(jnp.asarray(value[:, None]), jnp.asarray(wl), True), "to_film_rgb")
  rgb = rng.uniform(size=(n, 3)).astype(np.float32)
  _close(pspec.rgb_response(_t(wl), _t(rgb)), jspec.rgb_response(jnp.asarray(wl), jnp.asarray(rgb)),
         "rgb_response")
  _close(pspec.black_body_radiation(_t(wl), 2700.0),
         jspec.black_body_radiation(jnp.asarray(wl), 2700.0), "black_body", rtol=1e-5)
  bank_p = port_scenes[True][0].spec_values
  bank_j = jax_scenes[True][0].spec_values
  table = pspec.bank_at_wl(bank_p, _t(wl))
  _close(table, jspec.bank_at_wl(bank_j, jnp.asarray(wl)), "bank_at_wl")
  idx = rng.integers(0, bank_p.shape[0], n)
  q = pspec.query_bank(bank_p, _t(idx), _t(wl))
  _close(q, jspec.query_bank(bank_j, jnp.asarray(idx), jnp.asarray(wl)), "query_bank")
  # the per-bounce table and the bank give the same queries
  np.testing.assert_array_equal(table.gather(1, _t(idx)[:, None]).numpy(), q.numpy())
  sidx = idx.copy()
  sidx[:16] = -1
  wl_t = _t(wl)
  cached = port_scenes[True][0]._replace(spec_at_wl=(wl_t, table))
  for scene in (port_scenes[True][0], cached):
    _close(pspx.query_spd(scene, _t(sidx), wl_t, True),
           jspx.query_spd(jax_scenes[True][0], jnp.asarray(sidx), jnp.asarray(wl), True),
           "query_spd")
  _close(pspx.apply_rgb(_t(value[:, None]), _t(rgb), _t(wl), True),
         jspx.apply_rgb(jnp.asarray(value[:, None]), jnp.asarray(rgb), jnp.asarray(wl), True),
         "apply_rgb")
  for spectral, v in ((True, value[:, None]), (False, rgb)):
    _close(pspx.monochromatic(_t(v), spectral), jspx.monochromatic(jnp.asarray(v), spectral),
           "monochromatic")
    assert pspx.const(0.5, _t(v), spectral).shape == jspx.const(0.5, jnp.asarray(v), spectral).shape


def test_spectral_emitters_match_jax(jax_scenes, port_scenes):
  """The ceiling light's blackbody SPD at each lane's wavelength."""
  rng = np.random.default_rng(35)
  n = 4096
  js, ps = jax_scenes[True][0], port_scenes[True][0]
  wl = rng.uniform(390.0, 830.0, n).astype(np.float32)
  rnd = rng.uniform(size=n).astype(np.float32)
  rnd2 = rng.uniform(size=(n, 2)).astype(np.float32)
  pts = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3)).astype(np.float32)
  idx, _ = pemitters.sample_emitter_index(ps, _t(rnd))
  want = jemitters.sample_emitter(js, jnp.asarray(idx.numpy()), jnp.asarray(rnd2),
                                  jnp.asarray(pts), jnp.asarray(wl), True, classes=(0,))
  got = pemitters.sample_emitter(ps, idx, _t(rnd2), _t(pts), _t(wl), True)
  for name in ("value", "origin", "direction", "pdf_dir", "pdf_sample"):
    _close(getattr(got, name).numpy(), getattr(want, name), name)
  assert got.value.shape == (n, 1) and float(got.value.max()) > 0.0
  ei = rng.integers(-1, 2, n).astype(np.int32)
  org = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3)).astype(np.float32)
  vis = rng.uniform(size=n) < 0.5
  want = jemitters.area_radiance(js, jnp.asarray(ei), jnp.asarray(wl), jnp.asarray(org),
                                 jnp.asarray(pts), jnp.zeros((n, 2)), jnp.asarray(vis), True)
  got = pemitters.area_radiance(ps, _t(ei), _t(org), _t(pts), _t(vis), _t(wl), True)
  for g, w in zip(got, want):
    _close(g.numpy(), w, "area_radiance")


# ------------------------------------------------------------ BSDF helpers


def _unit(x):
  return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def test_microfacet_helpers_match_jax():
  rng = np.random.default_rng(32)
  n = 4096
  w_i = _unit(rng.normal(size=(n, 3)) * [1, 1, 0.5] + [0, 0, 0.6])
  w_i[:, 2] = np.abs(w_i[:, 2]) + 1e-3
  w_i = _unit(w_i)
  w_o = _unit(rng.normal(size=(n, 3)))
  alpha = np.exp(rng.uniform(np.log(1e-3), 0.0, (n, 2))).astype(np.float32)
  alpha[: n // 2, 1] = alpha[: n // 2, 0]
  rnd = rng.uniform(size=(n, 2)).astype(np.float32)
  m = _unit(w_i + w_o)
  J = jnp.asarray
  _close(pmf.ggx_d(_t(m), _t(alpha)), jmf.ggx_d(J(m), J(alpha)), "ggx_d")
  _close(pmf.smith_lambda(_t(w_o), _t(alpha)), jmf.smith_lambda(J(w_o), J(alpha)), "lambda")
  _close(pmf.ggx_g1(_t(w_o), _t(m), _t(alpha)), jmf.ggx_g1(J(w_o), J(m), J(alpha)), "g1")
  vm = pmf.sample_vndf(_t(rnd), _t(w_i), _t(alpha))
  _close(vm, jmf.sample_vndf(J(rnd), J(w_i), J(alpha)), "sample_vndf", atol=1e-5)
  _close(pmf.vndf_pdf(_t(w_i), vm, _t(alpha)),
         jmf.vndf_pdf(J(w_i), J(vm.numpy()), J(alpha)), "vndf_pdf")
  _close(pmf.ms_pdf(_t(w_i), _t(w_o), _t(alpha)), jmf.ms_pdf(J(w_i), J(w_o), J(alpha)), "ms_pdf")


@pytest.mark.parametrize("spectral", [True, False])
def test_fresnel_matches_jax(spectral):
  rng = np.random.default_rng(33 + spectral)
  n, c = 4096, (1 if spectral else 3)
  cos = rng.uniform(-1.0, 1.0, n).astype(np.float32)
  cos[:4] = [0.0, 1.0, -1.0, 1e-7]

  def ior(lo, hi):
    return rng.uniform(lo, hi, (n, c)).astype(np.float32)

  ext_eta, ext_k = np.ones((n, c), np.float32), np.zeros((n, c), np.float32)
  int_eta, int_k = ior(0.1, 2.5), ior(0.0, 4.0)
  int_k[: n // 2] = 0.0                           # dielectrics
  int_eta[:8] = ext_eta[:8]                       # equal IORs: F = 0
  int_k[:8] = 0.0
  is_cond = rng.uniform(size=n) < 0.5
  thick = np.where(rng.uniform(size=n) < 0.5, rng.uniform(100.0, 700.0, n), 0.0).astype(np.float32)
  tf_eta = np.where(rng.uniform(size=(n, 1)) < 0.8, ior(1.0, 2.0), 0.0).astype(np.float32)
  tf_k = np.zeros((n, c), np.float32)
  wl = (np.full((n, 1), 550.0) + rng.uniform(-150, 250, (n, c))).astype(np.float32)
  J = jnp.asarray
  got = pmf.fresnel(_t(cos), _t(ext_eta), _t(ext_k), _t(int_eta), _t(int_k), spectral,
                    int_is_conductor=_t(is_cond), tf_thickness=_t(thick), tf_eta=_t(tf_eta),
                    tf_k=_t(tf_k), tf_wavelengths=_t(wl))
  want = jmf.fresnel(J(cos), J(ext_eta), J(ext_k), J(int_eta), J(int_k), spectral,
                     int_is_conductor=J(is_cond), tf_thickness=J(thick), tf_eta=J(tf_eta),
                     tf_k=J(tf_k), tf_wavelengths=J(wl))
  _close(got, want, "fresnel")
  assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
  np.testing.assert_array_equal(got.numpy()[:8][thick[:8] == 0.0], 0.0)


# -------------------------------------------------------------------- lobes


def _shading(rng, n, jscene, pscene, spectral, classes):
  """The same random ShadingData for both packages, over the scene's
  materials of the given classes (the Cornell tall box is the smooth
  conductor, the gold sphere the alpha 0.05 one, the glass sphere a smooth
  dielectric). A quarter of the conductor and dielectric lanes get a random,
  possibly anisotropic roughness, so that every branch runs."""
  table = np.asarray(jscene.mat_table)
  mat_cls = table[:, ppacked.mat_column("cls")].astype(int)
  rows = np.flatnonzero(np.isin(mat_cls, classes))
  mat = rows[rng.integers(0, rows.size, n)]
  mat_rows = table[mat].copy()
  rough = np.isin(mat_cls[mat], (3, 4)) & (rng.uniform(size=n) < 0.25)
  col = ppacked.mat_column("roughness")
  mat_rows[rough, col:col + 2] = rng.uniform(0.01, 0.6, (int(rough.sum()), 2))
  nrm = _unit(rng.normal(size=(n, 3)))
  tan = _unit(np.cross(nrm, _unit(rng.normal(size=(n, 3)))))
  btn = np.cross(nrm, tan).astype(np.float32)
  w_i = _unit(rng.normal(size=(n, 3)))
  tex = rng.uniform(size=(n, 2)).astype(np.float32)
  wl = (rng.uniform(390.0, 830.0, n) if spectral else np.zeros(n)).astype(np.float32)
  J = jnp.asarray
  jsd = jlobes.ShadingData(w_i=J(w_i), nrm=J(nrm), tan=J(tan), btn=J(btn), geo_n=J(nrm),
                           tex=J(tex), wl=J(wl), medium=jnp.full(n, -1, jnp.int32),
                           mat=jpacked.unpack_material_rows(J(mat_rows)))
  psd = plobes.ShadingData(w_i=_t(w_i), nrm=_t(nrm), tan=_t(tan), btn=_t(btn), geo_n=_t(nrm),
                           tex=_t(tex), wl=_t(wl), medium=torch.full((n,), -1, dtype=torch.int32),
                           mat=ppacked.MaterialRows(_t(mat_rows)))
  return jsd, psd, mat_cls[mat]


def _agree(got, want, what):
  """Lanes (rows) whose values agree within the module tolerances."""
  g = np.asarray(got, np.float64).reshape(len(got), -1)
  w = np.asarray(want, np.float64).reshape(len(want), -1)
  ok = np.isclose(g, w, rtol=MODULE_RTOL, atol=MODULE_ATOL).all(axis=1)
  assert ok.mean() >= 1.0 - LANE_FLIP, (what, ok.mean())
  return ok


@pytest.mark.parametrize("spectral", [True, False])
@pytest.mark.parametrize("cls", [3, 4, 5])
def test_lobes_match_jax(jax_scenes, port_scenes, spectral, cls):
  """Conductor (smooth and alpha 0.05), Dielectric and Thinfilm: sample,
  evaluate and pdf, lane by lane."""
  rng = np.random.default_rng(40 + cls + 10 * spectral)
  n = 2048
  jscene, pscene = jax_scenes[spectral][0], port_scenes[spectral][0]
  jsd, psd, _ = _shading(rng, n, jscene, pscene, spectral, (cls,))
  rnd = rng.uniform(size=(n, pdispatch.NUM_SAMPLE_RND)).astype(np.float32)
  w_o = _unit(rng.normal(size=(n, 3)))
  name = {3: "conductor", 4: "dielectric", 5: "thinfilm"}[cls]
  want = getattr(jlobes, f"{name}_sample")(jscene, jsd, jnp.asarray(rnd), spectral)
  got = getattr(plobes, f"{name}_sample")(pscene, psd, _t(rnd), spectral)
  same = _agree(got.w_o.numpy(), want.w_o, "w_o")
  for field in plobes.BSDFSampleR._fields:
    g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
    if g.dtype == bool or field == "medium":
      assert (g == w)[same].all(), field
    else:
      _close(g[same], w[same], field)
  assert got.weight.shape == (n, 1 if spectral else 3)
  if cls == 5:
    return  # a delta lobe: no evaluate or pdf
  b, p = getattr(plobes, f"{name}_evaluate")(pscene, psd, _t(w_o), spectral)
  jb, jp = getattr(jlobes, f"{name}_evaluate")(jscene, jsd, jnp.asarray(w_o), spectral)
  ok = _agree(b.numpy(), jb, "evaluate") & _agree(p.numpy(), jp, "evaluate pdf")
  assert (b.numpy() > 0.0).any(axis=1).mean() > 0.1  # rough lanes scatter
  pp = getattr(plobes, f"{name}_pdf")(pscene, psd, _t(w_o), spectral)
  jpp = getattr(jlobes, f"{name}_pdf")(jscene, jsd, jnp.asarray(w_o), spectral)
  _agree(pp.numpy(), jpp, "pdf")
  _close(p.numpy()[ok], np.asarray(jp)[ok], "evaluate pdf")


@pytest.mark.parametrize("spectral", [True, False])
def test_dispatch_over_the_scene_classes_matches_jax(jax_scenes, port_scenes, spectral):
  rng = np.random.default_rng(50 + spectral)
  n = 2048
  jscene, pscene = jax_scenes[spectral][0], port_scenes[spectral][0]
  classes = jax_scenes[spectral][1].material_classes
  jsd, psd, cls = _shading(rng, n, jscene, pscene, spectral, classes)
  assert set(np.unique(cls)) == set(classes)
  rnd = rng.uniform(size=(n, pdispatch.NUM_SAMPLE_RND)).astype(np.float32)
  w_o = _unit(rng.normal(size=(n, 3)))
  want = jdispatch.sample(jscene, jsd, jnp.asarray(rnd), spectral, classes)
  got = pdispatch.sample(pscene, psd, _t(rnd), spectral, classes)
  same = _agree(got.w_o.numpy(), want.w_o, "w_o")
  for field in ("weight", "pdf", "eta"):
    _close(getattr(got, field).numpy()[same], np.asarray(getattr(want, field))[same], field)
  for field in ("is_delta", "is_reflection", "medium"):
    assert (getattr(got, field).numpy() == np.asarray(getattr(want, field)))[same].all()
  b, p = pdispatch.evaluate(pscene, psd, _t(w_o), spectral, classes)
  jb, jp = jdispatch.evaluate(jscene, jsd, jnp.asarray(w_o), spectral, classes)
  _agree(b.numpy(), jb, "evaluate")
  _agree(p.numpy(), jp, "evaluate pdf")
  _agree(pdispatch.pdf(pscene, psd, _t(w_o), spectral, classes).numpy(),
         jdispatch.pdf(jscene, jsd, jnp.asarray(w_o), spectral, classes), "pdf")
  np.testing.assert_array_equal(pdispatch.is_delta(psd).numpy(), np.asarray(jdispatch.is_delta(jsd)))
  _close(pdispatch.albedo(pscene, psd, spectral).numpy(),
         jdispatch.albedo(jscene, jsd, spectral), "albedo")


# ---------------------------------------------------------------- main path


def test_pt_step_matches_jax_on_the_materials_scene(jax_scenes, port_scenes):
  """Two spectral bounces with deferred NEE from the same 1024 lanes."""
  jscene, jconfig = jax_scenes[True]
  pscene, pconfig = port_scenes[True]
  ids = np.arange(1024) + 256
  jst = jpt.make_lane_payload(jscene, jconfig, jnp.asarray(ids, jnp.int32), jnp.int32(2 ** 30))
  pst = ppt.make_lane_payload(pscene, pconfig, torch.from_numpy(ids), 2 ** 30)
  _close(pst.wl.numpy(), jst.wl, "wl", rtol=1e-6, atol=1e-3)
  for step in range(2):
    jst = jpt.pt_step(jscene, jconfig, jst, deferred_nee=True)
    pst = ppt.pt_step(pscene, pconfig, pst)
    same = ((np.asarray(jst.alive) == pst.alive.numpy())
            & (np.asarray(jst.res_valid) == pst.res_valid.numpy()))
    assert same.mean() >= 0.98, f"step {step}"
    np.testing.assert_array_equal(pst.rng_state.numpy()[same].astype(np.uint32),
                                  np.asarray(jst.rng_state)[same])
    for name in ("ray_o", "ray_d", "throughput", "accumulated", "view_albedo", "eta",
                 "bsdf_pdf", "psh_o", "psh_d", "psh_tmax", "psh_rgb", "res_rgb"):
      g = getattr(pst, name).numpy()[same]
      w = np.asarray(getattr(jst, name))[same]
      close = np.isclose(g, w, rtol=1e-4, atol=1e-4)
      assert close.reshape(close.shape[0], -1).all(axis=1).mean() >= 0.98, (step, name)
    np.testing.assert_array_equal(pst.medium.numpy(), np.asarray(jst.medium))


def test_materials_render_matches_jax_pixel_by_pixel(jax_render, port_render):
  ref, ref_table, ref_rays = jax_render
  img, table, rays = port_render
  assert img.shape == ref.shape == (FILM[1], FILM[0], 3)
  assert np.isfinite(img).all()
  outliers = (np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(axis=-1)
  assert outliers.mean() <= OUTLIER_FRACTION, outliers.mean()
  assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())
  np.testing.assert_array_equal(table[:, 12], np.full(FILM[0] * FILM[1], SPP))
  np.testing.assert_array_equal(table[:, 12], ref_table[:, 12])
  assert rays == pytest.approx(ref_rays, rel=0.01)


def test_materials_render_is_physical(port_render):
  """A spectral sample's RGB may leave the gamut (negative channels), but
  its luminance Y is never negative; and the image mean lies in the range
  chip_smoke.py holds the card's 512x512 render to."""
  img = port_render[0]
  y = img @ pspec.RGB_TO_XYZ[1].astype(np.float64)
  assert y.min() >= -1e-5 * max(1.0, img.max())
  lo, hi = chip_smoke.MATERIALS_MEAN
  assert lo <= img.mean() <= hi, img.mean()


def test_render_entry_point_on_the_materials_scene(port_scenes, port_render):
  """`render` is render_samples_static + finalize_film, through the
  pair-tile plain versions on the CPU (no kernel launch counted)."""
  scene, config = port_scenes[True]
  before = dict(brute2_trace.launches)
  img = pfilm.result_image(ppt.render(scene, config, iterations=SPP, pool_size=POOL,
                                      device="cpu")).numpy()
  np.testing.assert_array_equal(img, port_render[0])
  assert brute2_trace.launches == before
