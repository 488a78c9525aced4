"""The port's shading set against the JAX package, lobe by lobe (CPU).

The classes, variations and options the shading slice brings: the
Translucent, Plastic, Mirror, Velvet, Principled and Void lobes, the
diffuse variations 1 (the Heitz rough-diffuse walk) and 2 (the vMF rough
diffuse), material images (colours, roughness, metalness, transmission,
normal maps), the blue-noise mask and the illuminant models.

Both packages stage the all-classes showcase (`tests/shading_showcase.py`)
through their own builders; the tables must be equal. 4,096 shading lanes
over its materials, made from numpy seeds with random uvs (so every image
is read), go through both packages' lobes and dispatch, the JAX side run
eagerly (one XLA operation at a time): values agree within atol 1e-5 and
rtol 1e-4 (test_dispatch_sorted's tolerance), bools and ints exactly. The
transcendental functions of XLA and PyTorch round apart by an ulp, so a
lane whose sample compares a draw with a Fresnel term or a walk's escape
probability may take the other branch: at most LANE_FLIP of the lanes may
disagree. The numpy illuminant models and the mask are held bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.core import bluenoise as jbluenoise
from etx_tracer_tpu.core import spectrum as jspectrum
from etx_tracer_tpu.render import images as jimages
from etx_tracer_tpu.render.bsdf import dispatch as jdispatch
from etx_tracer_tpu.render.bsdf import lobes as jlobes
from etx_tracer_tpu.render.bsdf import multiscatter as jms
from etx_tracer_tpu.scene import builder as jbuilder
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu.scene import ior as jior
from etx_tracer_tpu.scene import packed as jpacked
from etx_tracer_tpu.scene import spectral_data as jsdata
from etx_tracer_tpu.scene import types as jtypes
from etx_tracer_tpu_torch import scene_bridge
from etx_tracer_tpu_torch.core import bluenoise as pbluenoise
from etx_tracer_tpu_torch.core import spectrum as pspectrum
from etx_tracer_tpu_torch.render import images as pimages
from etx_tracer_tpu_torch.render.bsdf import common as pmf
from etx_tracer_tpu_torch.render.bsdf import dispatch as pdispatch
from etx_tracer_tpu_torch.render.bsdf import lobes as plobes
from etx_tracer_tpu_torch.render.bsdf import multiscatter as pms
from etx_tracer_tpu_torch.scene import builder as pbuilder
from etx_tracer_tpu_torch.scene import cornell as pcornell
from etx_tracer_tpu_torch.scene import ior as pior
from etx_tracer_tpu_torch.scene import packed as ppacked
from etx_tracer_tpu_torch.scene import spectral_data as psdata
from etx_tracer_tpu_torch.scene import types as ptypes
from tests import shading_showcase
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

N = 4096
ATOL, RTOL = 1e-5, 1e-4   # test_dispatch_sorted._tree_close
LANE_FLIP = 0.005         # lanes that may take the other branch
FILM = (16, 16)
MC = ptypes.MaterialClass


def _t(x):
  return torch.from_numpy(np.array(x))


def _unit(v):
  v = np.asarray(v, np.float64)
  return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


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


def _jax_showcase(**kw):
  return shading_showcase.showcase(jcornell, jbuilder, jtypes, jspectrum, jsdata, **kw)


def _port_showcase(**kw):
  return shading_showcase.showcase(pcornell, pbuilder, ptypes, pspectrum, psdata, **kw)


@pytest.fixture(scope="module")
def scenes():
  """{spectral: (JAX scene, JAX config, port scene, port config)} of the
  16x16 showcase at icosphere order 1, the JAX tree by its numpy builder."""
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    for s in (True, False):
      js, jc = _jax_showcase(film_size=FILM, spectral=s, order=1).build()
      ps, pc = _port_showcase(film_size=FILM, spectral=s, order=1).build(device="cpu")
      out[s] = (js, jc, ps, pc)
  return out


def _lanes(rng, scenes, spectral, classes, n=N):
  """The same random ShadingData for both packages over the showcase's
  materials of `classes`, random uvs and frames."""
  jscene, _, _, _ = scenes[spectral]
  table = np.asarray(jscene.mat_table)
  mat_cls = table[:, ppacked.mat_column("cls")].astype(int)
  rows = np.flatnonzero(np.isin(mat_cls, classes))
  mat_rows = table[rows[rng.integers(0, rows.size, n)]]
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
  return jsd, psd


def _rows_close(got, want):
  """Per lane: every value within the tolerance (NaN counts as 0, as in
  test_dispatch_sorted), bools and ints exactly."""
  g = np.asarray(got)
  w = np.asarray(want)
  g2, w2 = g.reshape(len(g), -1), w.reshape(len(w), -1)
  if g.dtype == bool or np.issubdtype(g.dtype, np.integer):
    return (g2 == w2).all(axis=1)
  g2, w2 = np.nan_to_num(g2.astype(np.float64)), np.nan_to_num(w2.astype(np.float64))
  return np.isclose(g2, w2, atol=ATOL, rtol=RTOL).all(axis=1)


def _agree(pairs, what, flip=LANE_FLIP):
  """All lanes agree on every (got, want) pair, but at most `flip` of them."""
  ok = np.ones(len(np.asarray(pairs[0][1])), bool)
  for g, w in pairs:
    ok &= _rows_close(g, w)
  assert ok.mean() >= 1.0 - flip, (what, ok.mean())
  return ok


def _sample_pairs(got, want):
  return [(getattr(got, f).numpy(), getattr(want, f)) for f in plobes.BSDFSampleR._fields]


# ------------------------------------------------------------- host data


ILLUMINANTS = ["d65", "daylight_5000k", "daylight_5500k", "daylight_6500k_noon_sky",
               "led_2700k_warm_white", "led_4000k_cool_white", "led_6500k_daylight",
               "led_high_cri_4000k", "blackbody_3000k", "tungsten_halogen_2856k"]


@pytest.mark.parametrize("name", ILLUMINANTS)
def test_illuminants_equal_jax(name):
  """The illuminant names resolve to the JAX package's spectra, bit for bit."""
  got = pior.IORDatabase().find(name)
  want = jior.IORDatabase().find(name)
  assert got[0] == want[0] == pspectrum.SpectralDistribution.CLASS_ILLUMINANT
  assert got[2] is None and want[2] is None
  assert got[1].cls == want[1].cls
  np.testing.assert_array_equal(got[1].values, want[1].values)


def test_illuminant_models_equal_jax():
  np.testing.assert_array_equal(psdata.d65().values, jsdata.d65().values)
  for cct in (4000.0, 6500.0, 12000.0):
    assert psdata.daylight_chromaticity(cct) == jsdata.daylight_chromaticity(cct)
    for g, w in zip(psdata.daylight_spd_values(cct), jsdata.daylight_spd_values(cct)):
      np.testing.assert_array_equal(g, w)
  for g, w in zip(psdata.led_spd_values(3000.0, True), jsdata.led_spd_values(3000.0, True)):
    np.testing.assert_array_equal(g, w)
  assert psdata.mccamy_cct(0.31, 0.33) == jsdata.mccamy_cct(0.31, 0.33)
  with pytest.raises(ValueError):
    psdata.daylight(3000.0)


def test_blue_noise_matches_jax():
  """The mask is the JAX package's shipped table; the rotated R2 points
  agree bit for bit."""
  np.testing.assert_array_equal(pbluenoise.mask_np(), jbluenoise._blue_noise_mask())
  rng = np.random.default_rng(60)
  px = rng.integers(0, 700, N)
  py = rng.integers(0, 700, N)
  it = rng.integers(0, 5000, N)
  for dim in (0, 2):
    want = jbluenoise.sample_2d(jnp.asarray(px, jnp.int32), jnp.asarray(py, jnp.int32),
                                jnp.asarray(it, jnp.int32), dim)
    got = pbluenoise.sample_2d(_t(px), _t(py), _t(it), dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("spectral", [True, False])
def test_showcase_tables_equal_jax(scenes, spectral):
  """The showcase at full size freezes the JAX package's tables and
  configuration, and the bridge carries them across unchanged."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    jscene, jconfig = _jax_showcase(film_size=FILM, spectral=spectral).build()
  arrays, config = _port_showcase(film_size=FILM, spectral=spectral).arrays()
  want = _jax_arrays(jscene)
  for name in arrays:
    got = np.asarray(arrays[name])
    assert got.dtype == want[name].dtype and got.shape == want[name].shape, name
    np.testing.assert_array_equal(got, want[name], err_msg=name)
  for f in dataclasses.fields(ptypes.SceneConfig):
    assert getattr(config, f.name) == getattr(jconfig, f.name), f.name
  assert arrays["tri_v0"].shape == (2916, 3)
  assert config.material_classes == (0, 1, 2, 3, 6, 8, 9, 10)
  assert config.diffuse_variations == (0, 1, 2) and config.has_alpha
  bridged, bconfig = scene_bridge.from_numpy(want, dataclasses.asdict(jconfig), device="cpu")
  assert bconfig == config
  assert bridged.material_features == ("scattering_img", "roughness_img", "metalness_img", "normal_img")
  np.testing.assert_array_equal(bridged.mat_table.numpy(), arrays["mat_table"])


def test_texture_gates_are_host_facts(scenes):
  """Without material images the lookups return their input itself (no
  kernel); the Cornell box's bank is empty and it has no textures."""
  pscene = scenes[True][2]
  assert pscene.material_features == ("scattering_img", "roughness_img", "metalness_img", "normal_img")
  plain, _ = pcornell.build_cornell_box(film_size=FILM).build(device="cpu")
  assert plain.material_features == ()
  _, psd = _lanes(np.random.default_rng(61), scenes, True, (MC.Plastic,), n=64)
  v = torch.ones((64, 1))
  assert pimages.apply_rgb_image(plain, v, psd.mat, "scattering_img", psd.tex) is v
  assert pimages.apply_scalar_image(plain, v, psd.mat, "roughness_img", psd.tex) is v
  assert pimages.apply_normal_map(plain, psd, psd.geo_n) is psd
  assert pimages.apply_rgb_image(pscene, v, psd.mat, "reflectance_img", psd.tex) is v


# ------------------------------------------------------------ the lookups


@pytest.mark.parametrize("spectral", [True, False])
def test_textured_helpers_match_jax(scenes, spectral):
  """The textured scattering and reflectance colours, roughness,
  Principled's factors and the normal map, lane by lane."""
  jscene, _, pscene, _ = scenes[spectral]
  rng = np.random.default_rng(62 + spectral)
  jsd, psd = _lanes(rng, scenes, spectral, (MC.Plastic, MC.Principled, MC.Diffuse))
  for fn in ("_scattering", "_reflectance"):
    np.testing.assert_allclose(getattr(plobes, fn)(pscene, psd, spectral).numpy(),
                               np.asarray(getattr(jlobes, fn)(jscene, jsd, spectral)),
                               atol=ATOL, rtol=RTOL, err_msg=fn)
  np.testing.assert_allclose(plobes._roughness(psd, pscene).numpy(),
                             np.asarray(jlobes._roughness(jsd, jscene)), atol=ATOL, rtol=RTOL)
  for g, w in zip(pdispatch._principled_factors(pscene, psd),
                  jdispatch._principled_factors(jscene, jsd)):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)
  got = pimages.apply_normal_map(pscene, psd, psd.geo_n)
  want = jimages.apply_normal_map(jscene, jsd, jsd.geo_n)
  mapped = psd.mat.normal_img.numpy() >= 0
  assert mapped.mean() > 0.05
  for f in ("nrm", "tan", "btn"):
    g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
    np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=f)
    assert not np.array_equal(g[mapped], getattr(psd, f).numpy()[mapped]), f
  alpha_p = pimages.apply_scalar_image(pscene, psd.mat.opacity, psd.mat, "scattering_img",
                                       psd.tex, channel=3)
  alpha_j = jsd.mat.opacity * jimages.scalar_image(
      jscene, jsd.mat.scattering_img, jsd.tex, jnp.full_like(jsd.mat.scattering_img, 3), 1.0)
  np.testing.assert_allclose(alpha_p.numpy(), np.asarray(alpha_j), atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------------ lobes


_LOBES = {MC.Translucent: "translucent", MC.Plastic: "plastic", MC.Mirror: "mirror",
          MC.Velvet: "velvet"}


@pytest.mark.parametrize("spectral", [True, False])
@pytest.mark.parametrize("cls", sorted(_LOBES))
def test_lobes_match_jax(scenes, spectral, cls):
  """Sample, evaluate and pdf of each new lobe, lane by lane."""
  jscene, _, pscene, _ = scenes[spectral]
  rng = np.random.default_rng(70 + cls + 20 * spectral)
  jsd, psd = _lanes(rng, scenes, spectral, (cls,))
  rnd = rng.uniform(size=(N, pdispatch.NUM_SAMPLE_RND)).astype(np.float32)
  w_o = _unit(rng.normal(size=(N, 3)))
  name = _LOBES[cls]
  got = getattr(plobes, f"{name}_sample")(pscene, psd, _t(rnd), spectral)
  want = getattr(jlobes, f"{name}_sample")(jscene, jsd, jnp.asarray(rnd), spectral)
  _agree(_sample_pairs(got, want), f"{name} sample")
  assert (got.pdf.numpy() > 0).mean() > 0.3
  if cls == MC.Mirror:
    return  # a delta lobe: no evaluate or pdf
  b, p = getattr(plobes, f"{name}_evaluate")(pscene, psd, _t(w_o), spectral)
  jb, jp = getattr(jlobes, f"{name}_evaluate")(jscene, jsd, jnp.asarray(w_o), spectral)
  _agree([(b.numpy(), jb), (p.numpy(), jp)], f"{name} evaluate")
  assert (b.numpy() > 0).any(axis=1).mean() > 0.1
  pp = getattr(plobes, f"{name}_pdf")(pscene, psd, _t(w_o), spectral)
  jpp = getattr(jlobes, f"{name}_pdf")(jscene, jsd, jnp.asarray(w_o), spectral)
  _agree([(pp.numpy(), jpp)], f"{name} pdf")


@pytest.mark.parametrize("spectral", [True, False])
def test_principled_matches_jax(scenes, spectral):
  """The metal / dielectric / plastic mixture under textured metalness,
  roughness and normal maps, with transmission 0.3."""
  jscene, _, pscene, _ = scenes[spectral]
  rng = np.random.default_rng(80 + spectral)
  jsd, psd = _lanes(rng, scenes, spectral, (MC.Principled,))
  rnd = rng.uniform(size=(N, pdispatch.NUM_SAMPLE_RND)).astype(np.float32)
  w_o = _unit(rng.normal(size=(N, 3)))
  got = pdispatch._principled_sample(pscene, psd, _t(rnd), spectral)
  want = jdispatch._principled_sample(jscene, jsd, jnp.asarray(rnd), spectral)
  _agree(_sample_pairs(got, want), "principled sample")
  b, p = pdispatch._principled_evaluate(pscene, psd, _t(w_o), spectral)
  jb, jp = jdispatch._principled_evaluate(jscene, jsd, jnp.asarray(w_o), spectral)
  _agree([(b.numpy(), jb), (p.numpy(), jp)], "principled evaluate")
  _agree([(pdispatch._principled_pdf(pscene, psd, _t(w_o), spectral).numpy(),
           jdispatch._principled_pdf(jscene, jsd, jnp.asarray(w_o), spectral))],
         "principled pdf")
  metal = pdispatch._principled_factors(pscene, psd)[0].numpy()
  assert 0.1 < (rnd[:, 5] < metal).mean() < 0.9   # both branches run


def _recording_while_loop(finals):
  """jax.lax.while_loop that keeps each loop's final carry."""
  inner = jax.lax.while_loop

  def run(cond, body, carry):
    out = inner(cond, body, carry)
    finals.append(out)
    return out
  return run


@pytest.mark.parametrize("spectral", [True, False])
@pytest.mark.parametrize("variation", [1, 2])
def test_diffuse_variations_match_jax(scenes, spectral, variation, monkeypatch):
  """The rough-diffuse variations' sample and evaluate on their lanes (the
  walk's on every lane of variation 1, its stream's state after the loop
  included), beside Lambert lanes."""
  jscene, _, pscene, _ = scenes[spectral]
  rng = np.random.default_rng(90 + variation + 10 * spectral)
  jsd, psd = _lanes(rng, scenes, spectral, (MC.Diffuse,))
  var = psd.mat.diffuse_variation.numpy()
  assert set(np.unique(var)) == {0, 1, 2}
  variations = (0, variation)
  rnd = rng.uniform(size=(N, pdispatch.NUM_SAMPLE_RND)).astype(np.float32)
  w_o = _unit(rng.normal(size=(N, 3)))
  finals = []
  monkeypatch.setattr(jax.lax, "while_loop", _recording_while_loop(finals))
  want = jlobes.diffuse_sample(jscene, jsd, jnp.asarray(rnd), spectral, variations)
  got = plobes.diffuse_sample(pscene, psd, _t(rnd), spectral, variations)
  _agree(_sample_pairs(got, want), f"diffuse {variation} sample")
  jb, jp = jlobes.diffuse_evaluate(jscene, jsd, jnp.asarray(w_o), spectral, variations)
  b, p = plobes.diffuse_evaluate(pscene, psd, _t(w_o), spectral, variations)
  ok = _agree([(b.numpy(), jb), (p.numpy(), jp)], f"diffuse {variation} evaluate")
  lanes = var == variation
  assert (b.numpy()[lanes & ok] > 0).any(axis=1).mean() > 0.2
  if variation != 1:
    assert not finals
    return
  # the walks themselves, and their streams after the loop
  frame, _ = plobes.normal_frame(psd)
  w_i_l, alpha = plobes._rough_diffuse_frame(pscene, psd, frame)
  albedo = plobes._scattering(pscene, psd, spectral)
  active = _t(lanes)
  J = jnp.asarray
  finals.clear()
  wo_j, e_j = jms.diffuse_sample_walk(J(w_i_l.numpy()), J(alpha.numpy()), J(albedo.numpy()),
                                      J(rnd), active0=J(lanes))
  wo_p, e_p, state_p = pms.diffuse_sample_walk(w_i_l, alpha, albedo, _t(rnd), active0=active)
  ok = _agree([(wo_p.numpy(), wo_j), (e_p.numpy(), e_j)], "sample walk")
  np.testing.assert_array_equal(state_p.numpy().astype(np.uint32), np.asarray(finals[-1][0]))
  w_o_l = torch.stack([(psd.tan * _t(w_o)).sum(-1), (psd.btn * _t(w_o)).sum(-1),
                       (psd.nrm * _t(w_o)).sum(-1)], dim=-1)
  seed_a = _t(w_o[:, 0]) + psd.tex[:, 0]
  seed_b = _t(w_o[:, 1]) + psd.tex[:, 1]
  v_j = jms.diffuse_eval_walk(J(w_i_l.numpy()), J(w_o_l.numpy()), J(alpha.numpy()),
                              J(albedo.numpy()), J(seed_a.numpy()), J(seed_b.numpy()),
                              active0=J(lanes))
  v_p, state_p = pms.diffuse_eval_walk(w_i_l, w_o_l, alpha, albedo, seed_a, seed_b,
                                       active0=active)
  _agree([(v_p.numpy(), v_j)], "eval walk")
  np.testing.assert_array_equal(state_p.numpy().astype(np.uint32), np.asarray(finals[-1][0]))
  assert int(finals[-1][5].max()) >= 2   # lanes scattered more than once


def test_vmf_and_walk_helpers_match_jax():
  """The vMF BRDF, lane by lane; but where the fit's middle branch
  cancels its large terms (m = -log(1 - sqrt(r)) in [0.6, 0.9], r the
  isotropic roughness) float32 rounding moves the result by up to a few
  percent, in the JAX package too: there the port may part from the eager
  JAX code on no more lanes than the jitted JAX code does."""
  rng = np.random.default_rng(95)
  w_i = _unit(np.abs(rng.normal(size=(N, 3))))
  w_o = _unit(np.abs(rng.normal(size=(N, 3))))
  alpha = rng.uniform(0.0, 1.0, (N, 2)).astype(np.float32)
  alpha[:64] = 0.0
  albedo = rng.uniform(size=(N, 3)).astype(np.float32)
  J = jnp.asarray
  args = (J(w_i), J(w_o), J(alpha), J(albedo))
  got = pms.vmf_diffuse_brdf(_t(w_i), _t(w_o), _t(alpha), _t(albedo)).numpy()
  want = np.asarray(jms.vmf_diffuse_brdf(*args))
  jitted = np.asarray(jax.jit(jms.vmf_diffuse_brdf)(*args))
  r = np.sqrt(alpha[:, 0].astype(np.float64) * alpha[:, 1])
  m = -np.log(np.maximum(1.0 - np.sqrt(r), 1e-7))
  cancel = (m >= 0.6) & (m <= 0.9)
  assert 0.05 < cancel.mean() < 0.3
  ok = _rows_close(got, want)
  assert ok[~cancel].all()
  assert (~ok[cancel]).mean() <= (~_rows_close(jitted, want)[cancel]).mean()
  x = rng.uniform(-3, 3, N).astype(np.float32)
  np.testing.assert_allclose(pms._erf(_t(x)).numpy(), np.asarray(jms._erf(J(x))), atol=ATOL)
  w = _unit(rng.normal(size=(N, 3)))
  a = pmf.clamp_alpha(_t(alpha)).numpy()
  np.testing.assert_allclose(pms._lambda(_t(w), _t(a)).numpy(),
                             np.asarray(jms._lambda(J(w), J(a))), atol=ATOL, rtol=RTOL)
  rnd = rng.uniform(size=(N, 2)).astype(np.float32)
  np.testing.assert_allclose(pms.sample_microfacet_normal(_t(w_i), _t(a), _t(rnd)).numpy(),
                             np.asarray(jms.sample_microfacet_normal(J(w_i), J(a), J(rnd))),
                             atol=1e-4, rtol=RTOL)


# --------------------------------------------------------------- dispatch


@pytest.mark.parametrize("spectral", [True, False])
def test_dispatch_over_every_class_matches_jax(scenes, spectral):
  """sample, evaluate, pdf and reverse_pdf over the showcase's eight
  classes with the three diffuse variations; Void keeps the null result."""
  jscene, jconfig, pscene, pconfig = scenes[spectral]
  classes = jconfig.material_classes
  variations = jconfig.diffuse_variations
  assert classes == pconfig.material_classes == (0, 1, 2, 3, 6, 8, 9, 10)
  rng = np.random.default_rng(100 + spectral)
  jsd, psd = _lanes(rng, scenes, spectral, classes)
  rnd = rng.uniform(size=(N, pdispatch.NUM_SAMPLE_RND)).astype(np.float32)
  w_o = _unit(rng.normal(size=(N, 3)))
  got = pdispatch.sample(pscene, psd, _t(rnd), spectral, classes, variations)
  want = jdispatch.sample(jscene, jsd, jnp.asarray(rnd), spectral, classes, variations)
  _agree(_sample_pairs(got, want), "sample")
  void = psd.mat.cls.numpy() == MC.Void
  assert void.any() and (got.pdf.numpy()[void] == 0).all() and got.is_delta.numpy()[void].all()
  b, p = pdispatch.evaluate(pscene, psd, _t(w_o), spectral, classes, variations)
  jb, jp = jdispatch.evaluate(jscene, jsd, jnp.asarray(w_o), spectral, classes, variations)
  _agree([(b.numpy(), jb), (p.numpy(), jp)], "evaluate")
  assert (b.numpy()[void] == 0).all()
  _agree([(pdispatch.pdf(pscene, psd, _t(w_o), spectral, classes).numpy(),
           jdispatch.pdf(jscene, jsd, jnp.asarray(w_o), spectral, classes))], "pdf")
  _agree([(pdispatch.reverse_pdf(pscene, psd, _t(w_o), spectral, classes).numpy(),
           jdispatch.reverse_pdf(jscene, jsd, jnp.asarray(w_o), spectral, classes))],
         "reverse_pdf")
  np.testing.assert_array_equal(pdispatch.is_delta(psd).numpy(),
                                np.asarray(jdispatch.is_delta(jsd)))
