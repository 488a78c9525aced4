"""The Heitz conductor and dielectric walks, and the lobes that take them
under `MS_BACKEND = "walk"`, against the JAX package (CPU).

The walks themselves run on numpy-seeded lanes with a Schlick Fresnel
closure written once for each package; the lobes on the all-classes
showcase's lanes (`tests/test_torch_shading.py`'s fixture and helpers),
with the JAX package's `lobes.MS_BACKEND` set to "walk" too. Values agree
within atol 1e-5 and rtol 1e-4 per lane, bools exactly. A walk's stream is
seeded from the bits of floats and every trip draws from it, so one ulp of
a transcendental that XLA and PyTorch round apart sends a lane on another
walk: at most LANE_FLIP of the lanes may disagree, as for the rough-diffuse
walk. A walked 16x16 render of the materials scene (its rough gold
conductor walks) is held against the JAX package's by an outlier count and
its mean, as the LUT render is (`tests/test_torch_materials.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import scenes as jscenes
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.render.bsdf import dispatch as jdispatch
from etx_tracer_tpu.render.bsdf import lobes as jlobes
from etx_tracer_tpu.render.bsdf import multiscatter as jms
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.render.bsdf import dispatch as pdispatch
from etx_tracer_tpu_torch.render.bsdf import lobes as plobes
from etx_tracer_tpu_torch.render.bsdf import multiscatter as pms
from tests.test_torch_shading import MC, N, _agree, _lanes, _sample_pairs, _t, _unit
from etx_tracer_tpu_torch.scene import materials as pmaterials
from tests.test_torch_shading import scenes  # noqa: F401  (the module fixture)
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)


def _walk_inputs(seed, c=3):
  """Lanes for the walks: w_i and w_o local with z > 0, alpha in
  [1/256, 1], rnd (N, 5), a Schlick F0 (N, c), eta in [1.1, 2.2] and the
  lanes that walk (about 90%)."""
  rng = np.random.default_rng(seed)
  w_i = _unit(np.abs(rng.normal(size=(N, 3))) + [0, 0, 0.05])
  w_o = _unit(rng.normal(size=(N, 3)))
  w_o[:, 2] = np.abs(w_o[:, 2])
  alpha = rng.uniform(1.0 / 256.0, 1.0, (N, 2)).astype(np.float32)
  rnd = rng.uniform(size=(N, 5)).astype(np.float32)
  f0 = rng.uniform(0.02, 0.95, (N, c)).astype(np.float32)
  eta = rng.uniform(1.1, 2.2, N).astype(np.float32)
  active = rng.uniform(size=N) < 0.9
  return w_i, w_o, alpha, rnd, f0, eta, active


def _schlick(xp, f0):
  def fres(cos_t):
    x = xp.clip(1.0 - xp.abs(cos_t), 0.0, 1.0)
    return f0 + (1.0 - f0) * (x * x * x * x * x)[..., None]
  return fres


def _schlick_sided(xp, f0):
  """A dielectric-like closure: F0 from inside is the same, a grazing
  boost from inside, so the side matters."""
  def fres(cos_t, outside):
    x = xp.clip(1.0 - xp.abs(cos_t), 0.0, 1.0)
    g = xp.where(outside, x * x * x * x * x, xp.sqrt(x))
    return f0 + (1.0 - f0) * g[..., None]
  return fres


def _mono(xp):
  return lambda v: v.mean(-1)


class _TorchNp:
  """numpy-like names over torch for the closures."""
  clip = staticmethod(torch.clamp)
  abs = staticmethod(torch.abs)
  where = staticmethod(torch.where)
  sqrt = staticmethod(torch.sqrt)


def test_conductor_walks_match_jax():
  """conductor_sample_walk and conductor_eval_walk, lane by lane, on the
  lanes of `active0` (the others stay at their start: zero energy)."""
  w_i, w_o, alpha, rnd, f0, _, active = _walk_inputs(101)
  J = jnp.asarray
  wo_j, e_j = jms.conductor_sample_walk(_schlick(jnp, J(f0)), J(w_i), J(alpha), J(rnd),
                                        active0=J(active))
  wo_p, e_p, _ = pms.conductor_sample_walk(_schlick(_TorchNp, _t(f0)), _t(w_i), _t(alpha),
                                           _t(rnd), active0=_t(active))
  ok = _agree([(wo_p.numpy(), wo_j), (e_p.numpy(), e_j)], "conductor sample walk")
  e = e_p.numpy()
  assert not e[~active].any()
  assert (e[active & ok] > 0).any(axis=1).mean() > 0.8
  seed_a, seed_b = w_o[:, 0] + 0.25, w_o[:, 1] + 0.5
  v_j = jms.conductor_eval_walk(_schlick(jnp, J(f0)), J(w_i), J(w_o), J(alpha), J(seed_a),
                                J(seed_b), active0=J(active))
  v_p, _ = pms.conductor_eval_walk(_schlick(_TorchNp, _t(f0)), _t(w_i), _t(w_o), _t(alpha),
                                   _t(seed_a), _t(seed_b), active0=_t(active))
  _agree([(v_p.numpy(), v_j)], "conductor eval walk")
  assert (v_p.numpy() > 0).any(axis=1).mean() > 0.5


def test_dielectric_walks_match_jax():
  """dielectric_sample_walk (direction, weight, side, escape) and
  dielectric_eval_walk toward both sides, lane by lane."""
  w_i, w_o, alpha, rnd, f0, eta, active = _walk_inputs(102, c=1)
  f0 = f0 * 0.2
  J = jnp.asarray
  want = jms.dielectric_sample_walk(_schlick_sided(jnp, J(f0)), _mono(jnp), J(eta), J(w_i),
                                    J(alpha), J(rnd), active0=J(active))
  got = pms.dielectric_sample_walk(_schlick_sided(_TorchNp, _t(f0)), _mono(torch), _t(eta),
                                   _t(w_i), _t(alpha), _t(rnd), active0=_t(active))
  ok = _agree([(g.numpy(), w) for g, w in zip(got[:4], want)], "dielectric sample walk")
  outside, escaped = got[2].numpy(), got[3].numpy()
  assert not escaped[~active].any()
  # walks leave on both sides
  assert 0.05 < outside[active & ok & escaped].mean() < 0.95
  seed_a, seed_b = w_o[:, 0] + 0.125, w_o[:, 1] + 0.75
  w_o_t = w_o.copy()
  w_o_t[N // 2:, 2] *= -1.0   # half the lanes scored through the surface
  wo_outside = w_o_t[:, 2] > 0.0
  v_j = jms.dielectric_eval_walk(_schlick_sided(jnp, J(f0)), _mono(jnp), J(eta), J(w_i),
                                 J(w_o_t), J(wo_outside), J(alpha), J(seed_a), J(seed_b),
                                 active0=J(active))
  v_p, _ = pms.dielectric_eval_walk(_schlick_sided(_TorchNp, _t(f0)), _mono(torch), _t(eta),
                                    _t(w_i), _t(w_o_t), _t(wo_outside), _t(alpha), _t(seed_a),
                                    _t(seed_b), active0=_t(active))
  _agree([(v_p.numpy(), v_j)], "dielectric eval walk")
  v = v_p.numpy()[:, 0]
  assert (v[wo_outside] > 0).mean() > 0.5 and (v[~wo_outside] > 0).mean() > 0.2


def test_walk_helpers_match_jax():
  """The dielectric walk's refraction, Gamma and Beta functions and MIS
  weights, lane by lane."""
  w_i, w_o, alpha, _, _, eta, active = _walk_inputs(103)
  J = jnp.asarray
  wm = _unit(w_i + w_o)
  pairs = [
      (pms._refract_local(_t(w_i), _t(wm), _t(eta)), jms._refract_local(J(w_i), J(wm), J(eta))),
      (pms._beta_fn(_t(eta), _t(eta[::-1].copy())), jms._beta_fn(J(eta), J(eta[::-1]))),
      (pms._mis_weight_conductor(_t(w_i), _t(w_o), _t(alpha)),
       jms._mis_weight_conductor(J(w_i), J(w_o), J(alpha))),
      (pms._mis_weight_dielectric(_t(w_i), _t(w_o), _t(active), _t(eta), _t(alpha)),
       jms._mis_weight_dielectric(J(w_i), J(w_o), J(active), J(eta), J(alpha))),
  ]
  _agree([(g.numpy(), w) for g, w in pairs], "walk helpers", flip=0.0)


def test_walks_run_only_on_active_lanes():
  """With no lane active the walks make no trip: zero energy, and the
  stream's state is its seed."""
  w_i, w_o, alpha, rnd, f0, eta, _ = _walk_inputs(104)
  off = torch.zeros(N, dtype=torch.bool)
  fres = _schlick(_TorchNp, _t(f0))
  _, e, state = pms.conductor_sample_walk(fres, _t(w_i), _t(alpha), _t(rnd), active0=off)
  assert not e.any()
  torch.testing.assert_close(state, pms._seed_from_floats(_t(rnd[:, 3]) + 0.123,
                                                          _t(rnd[:, 4]) + 0.771))
  v, _ = pms.dielectric_eval_walk(_schlick_sided(_TorchNp, _t(f0[:, :1])), _mono(torch),
                                  _t(eta), _t(w_i), _t(w_o), torch.ones(N, dtype=torch.bool),
                                  _t(alpha), _t(w_o[:, 0]), _t(w_o[:, 1]), active0=off)
  assert not v.any()


def _plastic_weight(jscene, jsd, w_o, spectral, mask):
  """The JAX plastic lobe's sample weight (bsdf / pdf) at the port's sampled
  directions. The plastic sample evaluates its lobe at the direction it
  drew, and the walk's stream is seeded from that direction's bits, which
  the two packages round apart on most lanes (a frame change, a reflection)
  while agreeing within the tolerance: so the weight is held to the JAX
  lobe at the same bits."""
  b, p = jlobes.plastic_evaluate(jscene, jsd, jnp.asarray(w_o.numpy()), spectral,
                                 mask=jnp.asarray(mask))
  return jnp.where(p[..., None] > 0, b / jnp.maximum(p, 1e-20)[..., None], 0.0)


@pytest.fixture
def walk(monkeypatch):
  """Both packages' lobes under the walks."""
  monkeypatch.setattr(jlobes, "MS_BACKEND", "walk")
  monkeypatch.setattr(plobes, "MS_BACKEND", "walk")


@pytest.mark.parametrize("spectral", [True, False])
@pytest.mark.parametrize("lobe", ["conductor", "dielectric", "plastic"])
def test_walk_lobes_match_jax(scenes, walk, spectral, lobe):
  """Sample, evaluate and pdf of the rough conductor (the showcase's
  Conductor and Principled rows), dielectric (Principled rows, which hold
  a dielectric IOR and textured roughness) and plastic lobes, each walking
  the lanes of its mask (three quarters of them)."""
  jscene, _, pscene, _ = scenes[spectral]
  rng = np.random.default_rng(110 + 3 * ["conductor", "dielectric", "plastic"].index(lobe)
                              + spectral)
  classes = {"conductor": (MC.Conductor, MC.Principled), "dielectric": (MC.Principled,),
             "plastic": (MC.Plastic,)}[lobe]
  jsd, psd = _lanes(rng, scenes, spectral, classes)
  rnd = rng.uniform(size=(N, pdispatch.NUM_SAMPLE_RND)).astype(np.float32)
  w_o = _unit(rng.normal(size=(N, 3)))
  mask = rng.uniform(size=N) < 0.75
  J = jnp.asarray
  got = getattr(plobes, f"{lobe}_sample")(pscene, psd, _t(rnd), spectral, mask=_t(mask))
  want = getattr(jlobes, f"{lobe}_sample")(jscene, jsd, J(rnd), spectral, mask=J(mask))
  if lobe == "plastic":
    want = want._replace(weight=_plastic_weight(jscene, jsd, got.w_o, spectral, mask))
  ok = _agree(_sample_pairs(got, want), f"{lobe} sample")
  assert (got.weight.numpy()[mask & ok] > 0).any(axis=1).mean() > 0.2
  b, p = getattr(plobes, f"{lobe}_evaluate")(pscene, psd, _t(w_o), spectral, mask=_t(mask))
  jb, jp = getattr(jlobes, f"{lobe}_evaluate")(jscene, jsd, J(w_o), spectral, mask=J(mask))
  _agree([(b.numpy(), jb), (p.numpy(), jp)], f"{lobe} evaluate")
  assert (b.numpy()[mask] > 0).any(axis=1).mean() > 0.1
  pp = getattr(plobes, f"{lobe}_pdf")(pscene, psd, _t(w_o), spectral)
  jpp = getattr(jlobes, f"{lobe}_pdf")(jscene, jsd, J(w_o), spectral)
  _agree([(pp.numpy(), jpp)], f"{lobe} pdf", flip=0.0)


def test_walk_principled_matches_jax(scenes, walk):
  """Principled's mixture under the walks (RGB; the lobe tests above run
  its conductor and dielectric views in both modes): each view walks the
  lanes that pick it (sample) or weigh it above 0 (evaluate)."""
  spectral = False
  jscene, _, pscene, _ = scenes[spectral]
  rng = np.random.default_rng(120)
  jsd, psd = _lanes(rng, scenes, spectral, (MC.Principled,))
  rnd = rng.uniform(size=(N, pdispatch.NUM_SAMPLE_RND)).astype(np.float32)
  w_o = _unit(rng.normal(size=(N, 3)))
  mask = rng.uniform(size=N) < 0.8
  J = jnp.asarray
  got = pdispatch._principled_sample(pscene, psd, _t(rnd), spectral, mask=_t(mask))
  want = jdispatch._principled_sample(jscene, jsd, J(rnd), spectral, mask=J(mask))
  # the lanes that pick the plastic view: its weight at the port's direction
  metal, trans = pdispatch._principled_factors(pscene, psd)
  plastic = ~(rnd[:, 5] < metal.numpy()) & ~(rnd[:, 6] < trans.numpy())
  assert 0.1 < plastic.mean() < 0.9
  w_plastic = _plastic_weight(jscene, jsd, got.w_o, spectral, mask & plastic)
  want = want._replace(weight=jnp.where(J(plastic)[:, None], w_plastic, want.weight))
  _agree(_sample_pairs(got, want), "principled sample")
  b, p = pdispatch._principled_evaluate(pscene, psd, _t(w_o), spectral, mask=_t(mask))
  jb, jp = jdispatch._principled_evaluate(jscene, jsd, J(w_o), spectral, mask=J(mask))
  _agree([(b.numpy(), jb), (p.numpy(), jp)], "principled evaluate")


FILM, SPP, POOL = (16, 16), 2, 256   # the walked render
OUTLIER_FRACTION = 0.02              # pixels off by > 1e-4 + 1e-3 |ref|
MEAN_RTOL = 0.005


def test_walked_materials_render_matches_jax(walk):
  """The spectral materials scene at 16x16, 2 spp, both packages under the
  walks: the port's image against the JAX package's jitted render. The
  jitted JAX functions read MS_BACKEND when they trace, so their caches are
  cleared before (a LUT trace of the same configuration may be cached) and
  after (so no later test reuses a walked trace)."""
  jax.clear_caches()
  try:
    with pytest.MonkeyPatch.context() as mp:
      mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
      jscene, jconfig = jscenes.materials(FILM, spectral=True).build()
    sums, jrays = jpt.render_samples_static(jscene, jconfig, 0, SPP, pool_size=POOL)
    fs = jpt.finalize_film(sums, SPP, jconfig.film_width)
    ref = np.asarray(fs.camera + fs.light)
  finally:
    jax.clear_caches()
  pscene, pconfig = pmaterials.build_materials_scene(FILM, spectral=True).build(device="cpu")
  psums, prays = ppt.render_samples_static(pscene, pconfig, 0, SPP, pool_size=POOL,
                                           device="cpu")
  img = pfilm.result_image(ppt.finalize_film(psums, SPP, pconfig.film_width)).numpy()
  assert np.isfinite(img).all() and img.shape == ref.shape
  outliers = (np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)).any(axis=-1)
  assert outliers.mean() <= OUTLIER_FRACTION, outliers.mean()
  assert abs(img.mean() - ref.mean()) <= MEAN_RTOL * abs(ref.mean())
  assert int(prays) == pytest.approx(float(jrays), rel=0.01)
