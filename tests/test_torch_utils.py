"""The port's utilities on the CPU: the validating build
(`utils/validate.py`, `SceneConfig.validate`), film checkpoints, the
profiler's trace and the typed options store, against the JAX package's
where it has the same function."""

import collections
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from etx_tracer_tpu.utils import options as joptions
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.models import vcm as pvcm
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.scene import cornell as pcornell
from etx_tracer_tpu_torch.utils import checkpoint, options, profiler, validate

torch.set_num_threads(1)

FILM = (8, 8)


def _scene(validate_build, nan_material=False, diffuse_only=True):
  scene, config = pcornell.build_cornell_box(film_size=FILM, diffuse_only=diffuse_only,
                                             max_path_length=3).build(device="cpu")
  if nan_material:
    # the red wall's RGB reflectance to NaN
    rgb = scene.spec_rgb.clone()
    red = (rgb == torch.tensor([1.0, 0.0, 0.0])).all(dim=-1)
    assert int(red.sum()) == 1
    rgb[red] = float("nan")
    scene = scene._replace(spec_rgb=rgb)
  return scene, dataclasses.replace(config, validate=validate_build)


def test_validating_build_names_the_failing_stage():
  scene, config = _scene(True, nan_material=True)
  with pytest.raises(validate.ValidationError, match="non-finite in pt:"):
    ppt.render(scene, config, iterations=1, device="cpu")
  with pytest.raises(validate.ValidationError, match="non-finite in vcm:"):
    pvcm.render(scene, config, pvcm.VCMOptions(), iterations=1, device="cpu")


def test_validating_build_passes_on_clean_scene():
  scene, config = _scene(True)
  for fs in (ppt.render(scene, config, iterations=2, device="cpu"),
             pvcm.render(scene, config, pvcm.VCMOptions(), iterations=1, device="cpu")):
    assert bool(torch.isfinite(pfilm.result_image(fs)).all())
  with pytest.raises(validate.ValidationError, match="non-finite in t:b"):
    validate.check_finite("t", a=torch.ones(3), b=torch.tensor([0.0, float("inf")]))


class _Ops(TorchDispatchMode):
  """Counts the ATen operators run while entered."""

  def __enter__(self):
    self.ops = []
    return super().__enter__()

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    self.ops.append(str(func))
    return func(*args, **(kwargs or {}))


def test_production_bounce_runs_no_check(monkeypatch):
  """With validate unset, check_finite is never called, and the bounce runs
  no operator beyond the validating bounce's (its checks stubbed out),
  which adds only the masks of the checks' arguments."""
  calls = []
  monkeypatch.setattr(validate, "check_finite", lambda tag, **a: calls.append(tag))
  bounces = {}
  for flag in (None, False, True):  # None: a first bounce that makes cached constants
    scene, config = _scene(bool(flag), diffuse_only=False)
    state = ppt.make_payload(scene, config, 0, device="cpu")
    calls.clear()
    with _Ops() as ops:
      ppt.pt_step(scene, config, state)
    bounces[flag] = collections.Counter(ops.ops)
    assert calls == (["pt:direct_emitter", "pt:bsdf_sample", "pt:nee", "pt:continuation"]
                     if flag else [])
  production, validating = bounces[False], bounces[True]
  assert not production - validating
  masks = validating - production
  assert set(masks) == {"aten.where.self", "aten.scalar_tensor.default",
                        "aten.unsqueeze.default"}, masks
  assert masks["aten.where.self"] == 9


def test_checkpoint_resumes_bit_for_bit(tmp_path):
  scene, config = _scene(False)
  whole = pfilm.allocate(*FILM, "cpu")
  for it in range(4):
    whole = ppt.render_iteration(scene, config, whole, it, device="cpu")
  half = pfilm.allocate(*FILM, "cpu")
  for it in range(2):
    half = ppt.render_iteration(scene, config, half, it, device="cpu")
  path = str(tmp_path / "film.npz")
  checkpoint.save_film(path, half)
  resumed = checkpoint.load_film(path, device="cpu")
  start = checkpoint.resume_iteration(resumed)
  assert start == 2
  for it in range(start, 4):
    resumed = ppt.render_iteration(scene, config, resumed, it, device="cpu")
  for name in pfilm.FilmState._fields:
    assert torch.equal(getattr(resumed, name), getattr(whole, name)), name
  assert sorted(np.load(path).files) == sorted(pfilm.FilmState._fields)


def _fill(store):
  store.add("integrator", "vcm", kind="enum", choices=["pt", "vcm", "bdpt"])
  store.add("max_path", 8, min=1, max=64)
  store.add("exposure", 0.5, min=-4.0, max=4.0)
  store.add("spectral", False)
  store.add("title", "cornell")
  store.set("max_path", 1000)
  store.set("exposure", -9)
  store.set("integrator", 2)
  store.set("spectral", 1)
  store.set("new_entry", [1, 2])
  return store


def test_options_json_matches_jax(tmp_path):
  ours, theirs = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
  _fill(options.Options()).save(ours)
  _fill(joptions.Options()).save(theirs)
  with open(ours) as a, open(theirs) as b:
    assert a.read() == b.read()
  loaded = options.Options().load(ours)
  assert loaded.items() == json.load(open(theirs))
  assert loaded.get("max_path") == 64 and loaded.get("integrator") == "bdpt"
  assert "title" in loaded and loaded.get("missing", 3) == 3


def test_device_trace_writes_a_trace(tmp_path):
  prof = profiler.Profiler()
  status = profiler.Status()
  scene, config = _scene(False)
  with profiler.device_trace(str(tmp_path / "trace")):
    with prof.scope("render"):
      _, rays = ppt.render_stats(scene, config, iterations=1, device="cpu")
  status.total_rays += int(rays)
  status.total_time += sum(prof.scopes["render"])
  files = os.listdir(tmp_path / "trace")
  assert len(files) == 1 and files[0].endswith(".json")
  with open(tmp_path / "trace" / files[0]) as f:
    events = json.load(f)["traceEvents"]
  assert any("aten::" in str(e.get("name", "")) for e in events)
  assert "render:" in prof.report() and status.mrays_per_second > 0
