"""The port's web viewer (`viewer/server.py`) on the CPU, mirroring
`tests/test_viewer.py`: editors restart the render, film layers and the
reference diff serve frames, the HTTP routes answer on port 0; the camera
controller, `render_preview` and `film.sample_heatmap` against the JAX
package's; one pass of the render loop fills the image and the film.
The render thread is started only in the last test."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.render import film as jfilm
from etx_tracer_tpu.scene import cornell as jcornell
from etx_tracer_tpu.viewer import server as jserver
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.scene import cornell as pcornell
from etx_tracer_tpu_torch.utils import image_io as pio
from etx_tracer_tpu_torch.viewer import server as pserver
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

FILM = (16, 16)
PREVIEW_PIXEL = 4
PREVIEW_RTOL, PREVIEW_ATOL = 1e-5, 1e-6


def _builder(module=pcornell, diffuse_only=False):
  return module.build_cornell_box(film_size=FILM, diffuse_only=diffuse_only, max_path_length=4)


def _state():
  st = pserver.ViewerState(_builder(), device="cpu")
  st.dirty = False
  return st


def _fake_film(st):
  h, w = st.image.shape[:2]
  rng = np.random.default_rng(0)
  layers = {name: rng.random((h, w, 3)).astype(np.float32)
            for name in ("camera", "variance_half", "normals", "albedo", "light")}
  layers["normals"] = layers["normals"] * 2 - 1
  fs = pfilm.FilmState(**layers, light_iteration=np.zeros((h, w, 3), np.float32),
                       iteration=np.int32(4))
  st.film = fs
  st.image = fs.camera + fs.light
  return fs


def test_material_edit_round_trips_restart():
  st = _state()
  info = st.scene_info()
  idx = next(i for i, m in enumerate(info["materials"]) if m["cls"] == "Conductor")
  st.edit_material(idx, {"roughness": 0.3, "cls": "Dielectric"})
  assert st.dirty  # an edit restarts accumulation
  info2 = st.scene_info()
  assert info2["materials"][idx]["cls"] == "Dielectric"
  assert abs(info2["materials"][idx]["roughness"] - 0.3) < 1e-6
  scene, config = st._build()
  assert 4 in config.material_classes and scene.tri_v0.device.type == "cpu"


def test_emission_scale_and_camera_edits_restart():
  st = _state()
  idx = next(i for i, m in enumerate(st.scene_info()["materials"]) if m["emissive"])
  before = st.builder.spectra[st.builder.materials[idx].emission_spec].integrated_rgb().copy()
  st.edit_material(idx, {"emission_scale": 2.0})
  after = st.builder.spectra[st.builder.materials[idx].emission_spec].integrated_rgb()
  np.testing.assert_allclose(after, before * 2.0, rtol=1e-6)
  assert st.dirty
  st.dirty = False
  st.edit_camera({"fov": 50.0, "lens_radius": 0.02, "focal_distance": 3.0})
  assert st.dirty
  cam = st.scene_info()["camera"]
  assert cam["fov"] == 50.0 and cam["lens_radius"] == 0.02 and cam["focal_distance"] == 3.0


def test_camera_controller_matches_jax(monkeypatch):
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
  ours, theirs = _state(), jserver.ViewerState(_builder(jcornell))
  for st in (ours, theirs):
    st.orbit(30.0, -12.0)
    st.pan(7.0, 3.0)
    st.dolly(-120.0)
    st.move((1, 0, -1))
    st.orbit(-5.0, 40.0)
  np.testing.assert_array_equal(ours.origin, theirs.origin)
  np.testing.assert_array_equal(ours.target, theirs.target)
  assert ours.dirty and ours.preview


def test_layer_images_and_diff(tmp_path):
  st = _state()
  _fake_film(st)
  for layer in ("result", "camera", "light", "normals", "albedo", "denoised", "noise"):
    img = st.layer_image(layer)
    assert img.shape == st.image.shape, layer
    assert np.isfinite(img).all(), layer
  assert not np.allclose(st.layer_image("camera"), st.layer_image("light"))
  ref_path = str(tmp_path / "ref.exr")
  pio.save_exr(ref_path, st.image)
  st.load_reference(ref_path)
  assert np.abs(st.layer_image("diff")).max() < 1e-5
  assert st.rmse() < 1e-5
  st.reference = st.reference * 0.5
  assert st.layer_image("reldiff").max() > 0 and st.rmse() > 0


def test_http_routes_serve(tmp_path):
  st = _state()
  _fake_film(st)
  server = pserver.make_server(st, port=0)
  port = server.server_address[1]
  t = threading.Thread(target=server.serve_forever, daemon=True)
  t.start()
  try:
    base = f"http://127.0.0.1:{port}"
    scene = json.loads(urllib.request.urlopen(base + "/scene", timeout=30).read())
    assert scene["materials"] and scene["camera"]["fov"] > 0
    for layer in ("result", "normals", "noise", "denoised"):
      png = urllib.request.urlopen(base + f"/frame?layer={layer}&exposure=1", timeout=30).read()
      assert pio.decode_png(png).shape == (FILM[1], FILM[0], 4)
    status = json.loads(urllib.request.urlopen(base + "/status", timeout=30).read())
    assert status["width"] == FILM[0] and status["integrator"] == "pt" and status["error"] is None
    assert b"etx-tracer-tpu" in urllib.request.urlopen(base + "/", timeout=30).read()

    def post(route, data, ctype="application/json"):
      req = urllib.request.Request(base + route, data=json.dumps(data).encode(), method="POST",
                                   headers={"Content-Type": ctype})
      return urllib.request.urlopen(req, timeout=30)

    # a cross-origin page can send text/plain without a preflight: refused
    with pytest.raises(urllib.error.HTTPError) as refused:
      post("/options", {"integrator": "vcm"}, "text/plain")
    assert refused.value.code == 415 and st.integrator == "pt"

    post("/material", {"index": 0, "roughness": 0.5})
    assert st.dirty
    st.dirty = False
    post("/camera", {"orbit": [10, 0]})
    assert st.dirty and st.preview
    post("/options", {"integrator": "vcm", "max_path": 3})
    assert st.integrator == "vcm" and st.builder.max_path_length == 3
    npy = urllib.request.urlopen(base + "/frame?layer=result&format=npy", timeout=30).read()
    np.testing.assert_array_equal(np.load(io.BytesIO(npy)), st.image)
    with pytest.raises(urllib.error.HTTPError) as gone:
      post("/save", {"path": str(tmp_path / "result.exr")})
    assert gone.value.code == 404 and not (tmp_path / "result.exr").exists()
  finally:
    server.shutdown()
    server.server_close()


def test_sample_heatmap_matches_jax():
  counts = np.random.default_rng(3).integers(0, 64, (9, 7)).astype(np.float32)
  for c, m in ((counts, 4), (counts, 0), (np.full((3, 3), 2.0, np.float32), 4)):
    np.testing.assert_allclose(pfilm.sample_heatmap(torch.from_numpy(c), m).numpy(),
                               np.asarray(jfilm.sample_heatmap(c, m)), rtol=1e-6, atol=1e-7)


def test_render_preview_matches_jax(monkeypatch):
  """On the diffuse box: the JAX package compiles its pool for the
  conductor box for about 100 s."""
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
  jscene, jconfig = _builder(jcornell, diffuse_only=True).build()
  pscene, pconfig = _builder(diffuse_only=True).build(device="cpu")
  want = np.asarray(jpt.render_preview(jscene, jconfig, pixel_size=PREVIEW_PIXEL))
  got = ppt.render_preview(pscene, pconfig, pixel_size=PREVIEW_PIXEL, device="cpu").numpy()
  assert got.shape == (FILM[1], FILM[0], 3) and got.max() > 0
  blocks = got.reshape(4, PREVIEW_PIXEL, 4, PREVIEW_PIXEL, 3)
  assert (blocks == blocks[:, :1, :, :1]).all()
  np.testing.assert_allclose(got, want, rtol=PREVIEW_RTOL, atol=PREVIEW_ATOL)


def test_render_loop_fills_image_and_film():
  """The render thread on the CPU: a preview, then accumulated iterations
  into the image and a host copy of the film."""
  st = pserver.ViewerState(_builder(), device="cpu")
  thread = threading.Thread(target=st.render_loop, daemon=True)
  thread.start()
  deadline = time.monotonic() + 120
  try:
    while time.monotonic() < deadline and (st.film is None or st.iteration < 2):
      assert st.error is None, st.error
      time.sleep(0.05)
  finally:
    st.running = False
    thread.join(timeout=120)
  assert not thread.is_alive()
  status = st.status()
  assert status["iteration"] >= 2 and status["previews"] >= 1 and status["error"] is None
  assert status["preview_seconds"] > 0 and status["iteration_seconds"] > 0
  assert isinstance(st.film.camera, np.ndarray) and st.film.camera.shape == (FILM[1], FILM[0], 3)
  assert np.isfinite(st.image).all() and st.image.mean() > 0
  np.testing.assert_array_equal(st.image, st.film.camera)


def test_move_during_an_iteration_gets_a_preview(monkeypatch):
  """A camera move that lands while an iteration runs, which then outlasts
  the preview hold (a 512x512 iteration takes longer than the hold on the
  card), is shown as a preview before accumulation restarts, as the JAX
  render loop does."""
  st = pserver.ViewerState(_builder(), device="cpu")
  monkeypatch.setattr(pserver, "_PREVIEW_HOLD", 0.0)  # every iteration outlasts the hold
  real, real_preview = ppt.render_samples_static, ppt.render_preview
  moved, in_preview = threading.Event(), threading.Event()

  def preview(*a, **k):  # renders its coarse film through render_samples_static
    in_preview.set()
    try:
      return real_preview(*a, **k)
    finally:
      in_preview.clear()

  def iteration_with_a_move(*a, **k):
    if not moved.is_set() and not in_preview.is_set():
      st.orbit(40.0, 0.0)
      moved.set()
    return real(*a, **k)

  monkeypatch.setattr(ppt, "render_preview", preview)
  monkeypatch.setattr(ppt, "render_samples_static", iteration_with_a_move)
  thread = threading.Thread(target=st.render_loop, daemon=True)
  thread.start()
  deadline = time.monotonic() + 120
  try:
    while time.monotonic() < deadline and not (moved.is_set() and st.iteration >= 1):
      assert st.error is None, st.error
      time.sleep(0.02)
  finally:
    st.running = False
    thread.join(timeout=120)
  assert not thread.is_alive() and st.error is None
  assert moved.is_set() and st.iteration >= 1
  # the first preview, then the move's, before the restarted iteration
  assert st.previews == 2, st.previews
