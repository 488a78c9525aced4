"""Interactive progressive web viewer.

Counterpart of `etx_tracer_tpu/viewer/server.py` (the reference's
sokol/ImGui app: raytracer/app.cxx, ui.cxx, camera_controller.hxx): a
stdlib HTTP server over a background render thread; the browser canvas
polls tonemapped PNG frames. A camera move renders 1/`preview_pixel_size`
previews (`path_tracing.render_preview`) and restarts accumulation.

The render thread is the only one that touches the device: it renders on
`ViewerState.device` (default: the CUDA card), copies each finished film to
the host, and swaps the host copies in under the lock; the HTTP threads
read only those host copies, and make their edits (camera, options, the
scene builder) under the lock, while the render thread builds from a copy
of the builder taken under it. POST routes take only `application/json`
bodies, so a page of another origin cannot post to them without a CORS
preflight, which the server does not answer. Beyond the JAX viewer,
`/status` also reports the integrator, a frame counter, the preview count,
the seconds of the last preview and of the last iteration, the trace
kernels' launch counts and the render thread's error if it died, and
`/frame?layer=...&format=npy` serves a layer's float values as a `.npy`
array (the film's row order: row 0 at the image bottom).

Parity with the reference UI (ui.cxx): integrator picker, exposure, path
length; material, medium, distant-emitter and camera editors bound to the
scene builder (every edit restarts accumulation); the film layers result,
camera, light, normals, albedo, denoised, noise; a reference image with
absolute and relative difference views and an RMSE readout.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from etx_tracer_tpu_torch import resolve_device
from etx_tracer_tpu_torch.render import film as film_mod

_PAGE = """<!doctype html>
<html><head><title>etx-tracer-tpu</title><style>
body{background:#111;color:#ccc;font-family:monospace;margin:0;display:flex}
#side{width:290px;padding:12px;overflow-y:auto;height:100vh;box-sizing:border-box}
#view{flex:1;display:flex;align-items:center;justify-content:center;height:100vh}
canvas{image-rendering:pixelated;max-width:100%;max-height:100%}
label{display:block;margin-top:6px;font-size:12px}
input,select{width:100%;box-sizing:border-box;background:#222;color:#ccc;border:1px solid #444}
#stats{margin-top:10px;font-size:11px;white-space:pre}
.mat{border:1px solid #333;margin-top:6px;padding:5px;font-size:11px}
h4{margin:10px 0 2px 0;font-size:12px;color:#8ac}
</style></head><body>
<div id="side">
  <b>etx-tracer-tpu</b>
  <label>integrator
    <select id="integrator"><option>pt</option><option>vcm</option><option>bdpt</option><option>lt</option></select>
  </label>
  <label>layer
    <select id="layer"><option>result</option><option>camera</option><option>light</option>
    <option>normals</option><option>albedo</option><option>denoised</option><option>noise</option>
    <option>diff</option><option>reldiff</option></select>
  </label>
  <label>exposure <input id="exposure" type="range" min="-4" max="4" step="0.1" value="0"></label>
  <label>max path <input id="maxpath" type="number" value="8" min="1" max="1024"></label>
  <h4>camera</h4>
  <label>fov <input id="fov" type="number" step="0.5"></label>
  <label>lens radius <input id="lens" type="number" step="0.001"></label>
  <label>focal distance <input id="focal" type="number" step="0.1"></label>
  <h4>reference</h4>
  <label>path <input id="refpath" placeholder="/path/to/ref.exr"></label>
  <h4>materials</h4>
  <div id="mats"></div>
  <h4>mediums</h4>
  <div id="meds"></div>
  <h4>emitters</h4>
  <div id="ems"></div>
  <div id="stats"></div>
  <p style="font-size:11px">drag: orbit &middot; shift-drag: pan<br>wheel: dolly &middot; WASD: move</p>
</div>
<div id="view"><canvas id="c"></canvas></div>
<script>
const c = document.getElementById('c'), ctx2 = () => c.getContext('2d');
async function post(url, data){
  await fetch(url, {method:'POST', headers: {'Content-Type': 'application/json'},
                    body: JSON.stringify(data)});
}
let busy = false;
async function refresh(){
  if (busy) return; busy = true;
  try{
    const r = await fetch('/frame?layer=' + layer.value +
                          '&exposure=' + Math.pow(2, exposure.value));
    const blob = await r.blob();
    const img = await createImageBitmap(blob);
    c.width = img.width; c.height = img.height;
    ctx2().drawImage(img, 0, 0);
    const s = await (await fetch('/status')).json();
    document.getElementById('stats').textContent =
      'iteration ' + s.iteration + '\\n' + s.width + 'x' + s.height +
      '\\n' + s.integrator + ', ' + (s.preview ? 'preview' : 'accumulating') +
      (s.rmse != null ? '\\nrmse vs ref ' + s.rmse.toFixed(5) : '');
  } finally { busy = false; }
}
setInterval(refresh, 250);
function field(parent, label, value, step, cb){
  const l = document.createElement('label'); l.textContent = label;
  const i = document.createElement('input');
  i.type = 'number'; i.step = step; i.value = value;
  i.addEventListener('change', () => cb(+i.value));
  l.appendChild(i); parent.appendChild(l);
}
async function buildEditors(){
  const s = await (await fetch('/scene')).json();
  fov.value = s.camera.fov; lens.value = s.camera.lens_radius;
  focal.value = s.camera.focal_distance;
  const mats = document.getElementById('mats'); mats.innerHTML = '';
  s.materials.forEach((m, i) => {
    const d = document.createElement('div'); d.className = 'mat';
    d.textContent = m.name + ' [' + m.cls + ']';
    const sel = document.createElement('select');
    for (const cl of s.material_classes){
      const o = document.createElement('option'); o.textContent = cl;
      if (cl === m.cls) o.selected = true; sel.appendChild(o);
    }
    sel.addEventListener('change', () => post('/material', {index: i, cls: sel.value}));
    d.appendChild(sel);
    field(d, 'roughness', m.roughness, 0.01, v => post('/material', {index: i, roughness: v}));
    field(d, 'metalness', m.metalness, 0.05, v => post('/material', {index: i, metalness: v}));
    field(d, 'transmission', m.transmission, 0.05, v => post('/material', {index: i, transmission: v}));
    if (m.emissive) field(d, 'emission scale', 1.0, 0.1,
                          v => post('/material', {index: i, emission_scale: v}));
    mats.appendChild(d);
  });
  const meds = document.getElementById('meds'); meds.innerHTML = '';
  s.mediums.forEach((m, i) => {
    const d = document.createElement('div'); d.className = 'mat';
    d.textContent = m.name;
    field(d, 'phase g', m.phase_g, 0.05, v => post('/medium', {index: i, phase_g: v}));
    meds.appendChild(d);
  });
  const ems = document.getElementById('ems'); ems.innerHTML = '';
  s.emitters.forEach((e, i) => {
    const d = document.createElement('div'); d.className = 'mat';
    d.textContent = 'distant ' + e.cls;
    field(d, 'angular size', e.angular_size, 0.01,
          v => post('/emitter', {index: i, angular_size: v}));
    ems.appendChild(d);
  });
}
buildEditors();
integrator.addEventListener('change', () => post('/options', {integrator: integrator.value}));
maxpath.addEventListener('change', () => post('/options', {max_path: +maxpath.value}));
fov.addEventListener('change', () => post('/camera_params', {fov: +fov.value}));
lens.addEventListener('change', () => post('/camera_params', {lens_radius: +lens.value}));
focal.addEventListener('change', () => post('/camera_params', {focal_distance: +focal.value}));
refpath.addEventListener('change', () => post('/reference', {path: refpath.value}));
let drag = null;
c.addEventListener('mousedown', e => drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey});
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  post('/camera', drag.pan ? {pan: [dx, dy]} : {orbit: [dx, dy]});
});
c.addEventListener('wheel', e => { e.preventDefault(); post('/camera', {dolly: e.deltaY}); });
window.addEventListener('keydown', e => {
  const m = {w:[0,0,1], s:[0,0,-1], a:[-1,0,0], d:[1,0,0], q:[0,-1,0], e:[0,1,0]}[e.key];
  if (m) post('/camera', {move: m});
});
</script></body></html>"""

# index == MaterialClass id (scene/types.py, material.hxx:53-68 order)
_CLASS_NAMES = ["Diffuse", "Translucent", "Plastic", "Conductor",
                "Dielectric", "Thinfilm", "Mirror", "Boundary", "Velvet",
                "Principled", "Void"]


# seconds after a camera move during which the render thread keeps
# rendering previews
_PREVIEW_HOLD = 0.4


class ViewerState:
  """Render-thread state machine (Integrator Stopped/Running/Preview,
  rt/integrators/integrator.hxx:12-98) and scene editing."""

  def __init__(self, builder, integrator="pt", preview_pixel_size=8, device=None):
    self.builder = builder
    self.integrator = integrator
    self.preview_pixel_size = preview_pixel_size
    self.device = resolve_device(device)
    self.lock = threading.RLock()
    self.dirty = True          # camera/options changed -> restart
    self.preview = True
    self.iteration = 0
    self.film = None           # host copy (numpy FilmState) of the last accumulation
    self.image = np.zeros((builder.film_size[1], builder.film_size[0], 3), np.float32)
    self.reference = None      # (H,W,3) reference image for diff views
    self.running = True
    self.last_move = 0.0
    self.frames = 0            # images swapped in, previews included
    self.previews = 0
    self.preview_seconds = None
    self.iteration_seconds = None
    self.error = None          # the render thread's traceback if it died
    # orbit state around the camera target
    self.origin = np.array(builder.camera_origin, np.float32)
    self.target = np.array(builder.camera_target, np.float32)
    self.up = np.array(builder.camera_up, np.float32)

  # -- camera controller (raytracer/camera_controller.hxx:9-159) ----------

  # Every edit below runs under the lock: the HTTP threads make them while
  # the render thread reads the camera, the options and the builder.

  def orbit(self, dx, dy):
    with self.lock:
      v = self.origin - self.target
      r = np.linalg.norm(v)
      theta = np.arctan2(v[0], v[2]) - dx * 0.01
      phi = np.arccos(np.clip(v[1] / max(r, 1e-6), -1, 1)) - dy * 0.01
      phi = np.clip(phi, 0.05, np.pi - 0.05)
      self.origin = self.target + r * np.array(
          [np.sin(phi) * np.sin(theta), np.cos(phi), np.sin(phi) * np.cos(theta)],
          np.float32)
      self._moved()

  def pan(self, dx, dy):
    with self.lock:
      fwd = self.target - self.origin
      fwd /= max(np.linalg.norm(fwd), 1e-6)
      side = np.cross(fwd, self.up)
      side /= max(np.linalg.norm(side), 1e-6)
      upv = np.cross(side, fwd)
      d = (-dx * side + dy * upv) * 0.005 * max(np.linalg.norm(self.target - self.origin), 0.1)
      self.origin = self.origin + d
      self.target = self.target + d
      self._moved()

  def dolly(self, amount):
    with self.lock:
      v = self.origin - self.target
      self.origin = self.target + v * float(np.exp(amount * 0.001))
      self._moved()

  def move(self, m):
    with self.lock:
      fwd = self.target - self.origin
      fwd /= max(np.linalg.norm(fwd), 1e-6)
      side = np.cross(fwd, self.up)
      side /= max(np.linalg.norm(side), 1e-6)
      step = (m[0] * side + m[1] * self.up + m[2] * fwd) * 0.1 \
          * max(np.linalg.norm(self.target - self.origin), 0.1)
      self.origin = self.origin + step
      self.target = self.target + step
      self._moved()

  def _moved(self):
    with self.lock:
      self.dirty = True
      self.preview = True
      self.last_move = time.time()

  def set_options(self, data: dict):
    """The `/options` route: the integrator and the path length."""
    with self.lock:
      if "integrator" in data:
        self.integrator = data["integrator"]
        self._moved()
      if "max_path" in data:
        self.builder.max_path_length = int(data["max_path"])
        self._moved()

  # -- scene editing (ui.cxx material/medium/emitter/camera editors) -------

  def scene_info(self) -> dict:
    with self.lock:
      return self._scene_info()

  def _scene_info(self) -> dict:
    b = self.builder
    mats = []
    for m in b.materials:
      mats.append({
          "name": m.name,
          "cls": _CLASS_NAMES[m.cls] if m.cls < len(_CLASS_NAMES) else str(m.cls),
          "roughness": float(m.roughness[0]),
          "metalness": float(m.metalness),
          "transmission": float(m.transmission),
          "two_sided": bool(m.two_sided),
          "emissive": m.emission_spec >= 0,
      })
    meds = [{"name": m.name, "phase_g": float(m.phase_g), "cls": m.cls}
            for m in b.mediums]
    ems = [{"cls": int(e.cls), "direction": list(map(float, e.direction)),
            "angular_size": float(e.angular_size)}
           for e in b.distant_emitters]
    return {
        "materials": mats, "mediums": meds, "emitters": ems,
        "material_classes": _CLASS_NAMES,
        "camera": {"fov": float(b.camera_fov),
                   "lens_radius": float(b.lens_radius),
                   "focal_distance": float(b.focal_distance)},
    }

  def edit_material(self, index: int, data: dict):
    with self.lock:
      self._edit_material(index, data)

  def _edit_material(self, index: int, data: dict):
    b = self.builder
    m = b.materials[index]
    rep = {}
    if "cls" in data:
      rep["cls"] = _CLASS_NAMES.index(data["cls"])
    if "roughness" in data:
      r = float(data["roughness"])
      rep["roughness"] = (r, r)
    for k in ("metalness", "transmission", "opacity"):
      if k in data:
        rep[k] = float(data[k])
    if "two_sided" in data:
      rep["two_sided"] = bool(data["two_sided"])
    if "emission_scale" in data and m.emission_spec >= 0:
      # re-point the material at a scaled copy of its emission SPD
      spd = copy.deepcopy(b.spectra[m.emission_spec])
      spd.scale(float(data["emission_scale"]))
      rep["emission_spec"] = b.add_spectrum(spd)
    b.materials[index] = dataclasses.replace(m, **rep)
    self._moved()

  def edit_medium(self, index: int, data: dict):
    rep = {}
    if "phase_g" in data:
      rep["phase_g"] = float(data["phase_g"])
    with self.lock:
      b = self.builder
      b.mediums[index] = dataclasses.replace(b.mediums[index], **rep)
      self._moved()

  def edit_emitter(self, index: int, data: dict):
    rep = {}
    if "angular_size" in data:
      rep["angular_size"] = float(data["angular_size"])
    if "direction" in data:
      rep["direction"] = tuple(map(float, data["direction"]))
    with self.lock:
      b = self.builder
      b.distant_emitters[index] = dataclasses.replace(b.distant_emitters[index], **rep)
      self._moved()

  def edit_camera(self, data: dict):
    with self.lock:
      b = self.builder
      if "fov" in data:
        b.camera_fov = float(data["fov"])
      if "lens_radius" in data:
        b.lens_radius = float(data["lens_radius"])
      if "focal_distance" in data:
        b.focal_distance = float(data["focal_distance"])
      self._moved()

  def load_reference(self, path: str):
    from etx_tracer_tpu_torch.utils import image_io
    ref = np.asarray(image_io.load_image(path, srgb_to_linear=False))[..., :3]
    with self.lock:
      # files are top-down; film arrays keep row 0 at the image BOTTOM
      self.reference = ref[::-1].copy()

  # -- film layers (Film layer display + ref diff, options.hxx:9-55) ------

  def layer_image(self, layer: str) -> np.ndarray:
    """A film layer as an (H,W,3) host array, from the host copies."""
    with self.lock:
      film, img, reference = self.film, self.image, self.reference
    if film is None or layer in ("result", ""):
      base = img
    elif layer == "camera":
      base = film.camera
    elif layer == "light":
      base = film.light
    elif layer == "normals":
      base = film.normals * 0.5 + 0.5
    elif layer == "albedo":
      base = film.albedo
    elif layer == "denoised":
      from etx_tracer_tpu_torch.render import denoiser
      base = denoiser.denoise(*(torch.from_numpy(x) for x in (film.camera, film.normals,
                                                              film.albedo))).numpy()
    elif layer == "noise":
      est = film_mod.noise_estimate(film_mod.FilmState(*(torch.as_tensor(x) for x in film)))
      base = film_mod.sample_heatmap(est * 255.0, min_samples=0).numpy()
    else:
      base = img
    if layer in ("diff", "reldiff") and reference is not None and reference.shape == img.shape:
      d = np.abs(img - reference)
      if layer == "reldiff":
        d = d / np.maximum(np.abs(reference), 1e-3)
      base = d
    return base

  def rmse(self):
    if self.reference is None or self.reference.shape != self.image.shape:
      return None
    return float(np.sqrt(((self.image - self.reference) ** 2).mean()))

  def status(self) -> dict:
    """The render's progress, as `/status` serves it, with the trace
    kernels' launch counts of this process."""
    from etx_tracer_tpu_torch.ops import trace
    with self.lock:
      return {
          "iteration": self.iteration,
          "preview": self.preview,
          "width": int(self.image.shape[1]),
          "height": int(self.image.shape[0]),
          "rmse": self.rmse(),
          "integrator": self.integrator,
          "frames": self.frames,
          "previews": self.previews,
          "preview_seconds": self.preview_seconds,
          "iteration_seconds": self.iteration_seconds,
          "error": self.error,
          "launches": trace.launch_counts(),
      }

  # -- render thread -------------------------------------------------------

  def _build(self):
    """The scene and config on the device, built from a copy of the builder
    taken under the lock (the edits replace list entries and set fields, so
    copying the lists keeps the copy whole), with the controller's camera."""
    with self.lock:
      b = copy.copy(self.builder)
      for k, v in vars(b).items():
        if isinstance(v, (list, dict)):
          setattr(b, k, copy.copy(v))
      b.set_camera(self.origin, self.target, self.up, b.camera_fov, b.film_size,
                   lens_radius=b.lens_radius, focal_distance=b.focal_distance)
    return b.build(device=self.device)

  def render_loop(self):
    """Render until `running` is cleared: a preview after every change,
    then full-resolution iterations, each film copied to the host and
    swapped in under the lock. An exception ends the loop; its traceback
    goes to `error` (and `/status`)."""
    try:
      self._render_loop()
    except Exception:
      with self.lock:
        self.error = traceback.format_exc()
      raise

  def _render_loop(self):
    from etx_tracer_tpu_torch.models import path_tracing
    dev = self.device
    scene, config = self._build()
    sums = None
    vcm_fs = None
    iters_done = 0
    while self.running:
      with self.lock:
        dirty, integrator = self.dirty, self.integrator
        self.dirty = False
        if dirty:
          # restart before the preview test: a change that came during a
          # longer iteration than the hold still gets its preview
          iters_done = 0
        preview = self.preview and (time.time() - self.last_move < _PREVIEW_HOLD
                                    or iters_done == 0)
      if dirty:
        scene, config = self._build()
        sums = None
        vcm_fs = None
      t0 = time.perf_counter()
      if preview:
        img = path_tracing.render_preview(scene, config, pixel_size=self.preview_pixel_size,
                                          iterations=1, device=dev).cpu().numpy()
        with self.lock:
          if not self.dirty:
            self.image = img
            self.iteration = 0
            self.frames += 1
            self.previews += 1
            self.preview_seconds = time.perf_counter() - t0
            self.preview = (False if time.time() - self.last_move > _PREVIEW_HOLD
                            else self.preview)
        continue
      # accumulate one full-resolution iteration
      if integrator in ("vcm", "bdpt", "lt"):
        from etx_tracer_tpu_torch.models import vcm as vcm_mod
        opts = {"bdpt": vcm_mod.bdpt_options,
                "lt": vcm_mod.light_tracing_options}.get(integrator)
        options = opts() if opts else vcm_mod.VCMOptions()
        if vcm_fs is None:
          vcm_fs = film_mod.allocate(config.film_width, config.film_height, dev)
        vcm_fs = vcm_mod.render_iteration(scene, config, options, vcm_fs, iters_done, dev)
        film = film_to_host(vcm_fs)
        img = film.camera + film.light
      else:
        new_sums, _ = path_tracing.render_samples_static(scene, config, iters_done, 1,
                                                         device=dev)
        sums = new_sums if sums is None else path_tracing.FilmSums(sums.table + new_sums.table)
        film = film_to_host(path_tracing.finalize_film(sums, iters_done + 1, config.film_width))
        img = film.camera
      iters_done += 1
      with self.lock:
        if not self.dirty:
          self.image = img
          self.film = film
          self.iteration = iters_done
          self.frames += 1
          self.iteration_seconds = time.perf_counter() - t0
          self.preview = False


def film_to_host(fs: film_mod.FilmState) -> film_mod.FilmState:
  """The film's layers as host numpy arrays, so that layer reads never wait
  on the device (the JAX viewer's `jax_film_to_host`)."""
  return film_mod.FilmState(*(x.cpu().numpy() for x in fs))


def serve(builder, host="127.0.0.1", port=8612, device=None):
  """Serve the viewer of `builder`'s scene, rendered on `device` (default:
  the CUDA card, which must exist), until interrupted."""
  state = ViewerState(builder, device=device)
  thread = threading.Thread(target=state.render_loop, daemon=True)
  thread.start()
  server = make_server(state, host, port)
  print(f"[etx-tpu] viewer at http://{host}:{server.server_address[1]} on {state.device}",
        flush=True)
  try:
    server.serve_forever()
  except KeyboardInterrupt:
    pass
  finally:
    state.running = False
    server.server_close()
  return server


def make_server(state: ViewerState, host="127.0.0.1", port=8612):
  """HTTP server over a ViewerState (separate from `serve`, so a test can
  run it without the render thread)."""
  from etx_tracer_tpu_torch.utils import image_io

  class Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
      pass

    def _send(self, code, body, ctype="text/html"):
      self.send_response(code)
      self.send_header("Content-Type", ctype)
      self.send_header("Content-Length", str(len(body)))
      self.end_headers()
      self.wfile.write(body)

    def do_GET(self):
      if self.path.startswith("/frame"):
        exposure = 1.0
        layer = "result"
        fmt = "png"
        q = self.path.split("?", 1)[-1] if "?" in self.path else ""
        for kv in q.split("&"):
          if kv.startswith("exposure="):
            try:
              exposure = float(kv.split("=", 1)[1])
            except ValueError:
              pass
          elif kv.startswith("layer="):
            layer = kv.split("=", 1)[1]
          elif kv.startswith("format="):
            fmt = kv.split("=", 1)[1]
        img = state.layer_image(layer)
        if fmt == "npy":
          buf = io.BytesIO()
          np.save(buf, np.ascontiguousarray(img, np.float32))
          self._send(200, buf.getvalue(), "application/octet-stream")
        else:
          self._send(200, image_io.encode_png(img, exposure=exposure), "image/png")
      elif self.path.startswith("/scene"):
        self._send(200, json.dumps(state.scene_info()).encode(),
                   "application/json")
      elif self.path.startswith("/status"):
        self._send(200, json.dumps(state.status()).encode(), "application/json")
      else:
        self._send(200, _PAGE.encode())

    def do_POST(self):
      n = int(self.headers.get("Content-Length", 0))
      body = self.rfile.read(n)
      ctype = self.headers.get("Content-Type", "").split(";")[0].strip().lower()
      if ctype != "application/json":
        self._send(415, json.dumps({"error": "POST bodies are application/json"}).encode(),
                   "application/json")
        return
      data = json.loads(body or b"{}")
      if self.path == "/camera":
        if "orbit" in data:
          state.orbit(*data["orbit"])
        elif "pan" in data:
          state.pan(*data["pan"])
        elif "dolly" in data:
          state.dolly(data["dolly"])
        elif "move" in data:
          state.move(data["move"])
      elif self.path == "/camera_params":
        state.edit_camera(data)
      elif self.path == "/material":
        state.edit_material(int(data.pop("index")), data)
      elif self.path == "/medium":
        state.edit_medium(int(data.pop("index")), data)
      elif self.path == "/emitter":
        state.edit_emitter(int(data.pop("index")), data)
      elif self.path == "/reference":
        try:
          state.load_reference(data["path"])
        except (OSError, KeyError, ValueError) as e:  # surface bad paths to the client
          self._send(400, json.dumps({"error": str(e)}).encode(),
                     "application/json")
          return
      elif self.path == "/options":
        state.set_options(data)
      else:
        self._send(404, json.dumps({"error": f"no route {self.path}"}).encode(),
                   "application/json")
        return
      self._send(200, b"{}", "application/json")

  return ThreadingHTTPServer((host, port), Handler)
