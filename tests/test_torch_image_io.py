"""The port's image files and preferences against the JAX package (CPU).

`etx_tracer_tpu_torch/utils/image_io.py` is a numpy copy of the JAX
package's: for the same array both write the same bytes (EXR with none,
rle, zips and zip compression, FLOAT and HALF pixels; PNG with and without
the flip and the tone map), and both decode the same files to the same
arrays (EXR, PNG, Radiance HDR flat and run-length encoded). PIZ goes
through each package's native library (`tests/test_torch_native.py` holds
the two against each other); without it a PIZ write gives the bytes of the
other package's PIZ write without its helper (ZIP), and a PIZ read raises.
The preferences file is shared: what one package records, the other reads.
"""

import json

import numpy as np
import pytest

from etx_tracer_tpu import native as jnative
from etx_tracer_tpu_torch import native as pnative
from etx_tracer_tpu.utils import image_io as jio
from etx_tracer_tpu.utils import prefs as jprefs
from etx_tracer_tpu_torch.utils import image_io as pio
from etx_tracer_tpu_torch.utils import prefs as pprefs
from tests.test_torch_images import load_native

COMPRESSIONS = ["none", "rle", "zips", "zip"]


def _image(h=37, w=23, seed=7):
  """A seeded HDR image with flat runs (so RLE and the predictor have work)
  and rows scaled up (so HALF rounds)."""
  rs = np.random.default_rng(seed)
  img = (rs.random((h, w, 3)) * 8.0).astype(np.float32)
  img[::3] *= 64.0
  img[5:9, 3:17] = 0.25
  return img


def _bytes(path):
  with open(path, "rb") as f:
    return f.read()


@pytest.mark.parametrize("compression", COMPRESSIONS)
@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("flip", [False, True])
def test_exr_bytes_and_arrays_equal_jax(tmp_path, compression, half, flip):
  img = _image()
  p, j = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
  pio.save_exr(p, img, flip=flip, compression=compression, half=half)
  jio.save_exr(j, img, flip=flip, compression=compression, half=half)
  assert _bytes(p) == _bytes(j)
  got, want = pio.load_exr(j), jio.load_exr(j)
  assert got.dtype == want.dtype and np.array_equal(got, want)
  gc, wc = pio.load_exr_channels(p), jio.load_exr_channels(p)
  assert gc["size"] == wc["size"] and list(gc["channels"]) == list(wc["channels"])
  for name in wc["channels"]:
    assert np.array_equal(gc["channels"][name], wc["channels"][name]), name
  ref = img.astype("<f2").astype(np.float32) if half else img
  assert np.array_equal(got, ref[::-1] if flip else ref)


def test_piz_writes_what_jax_writes_without_its_helper(tmp_path, monkeypatch):
  """Without the native library both packages write ZIP for PIZ."""
  img = _image(40, 9)
  p, j = str(tmp_path / "port.exr"), str(tmp_path / "jax.exr")
  monkeypatch.setattr(pnative, "load", lambda: None)
  pio.save_exr(p, img, compression="piz")
  monkeypatch.setattr(jnative, "load", lambda: None)
  jio.save_exr(j, img, compression="piz")
  assert _bytes(p) == _bytes(j)
  assert np.array_equal(pio.load_exr(p), img[::-1])


def test_piz_read_raises_as_jax_does_without_its_helper(tmp_path, monkeypatch):
  """A PIZ file that the JAX package wrote reads back through its helper;
  without the native library the port's reader raises."""
  load_native()
  path = str(tmp_path / "piz.exr")
  flat = np.full((40, 9, 3), 0.5, np.float32)  # compresses: PIZ blocks are kept
  jio.save_exr(path, flat, compression="piz", half=True)
  assert np.array_equal(jio.load_exr(path), flat)
  raw = _bytes(path)
  tag = b"compression\x00compression\x00"
  assert raw[raw.index(tag) + len(tag) + 4] == 4  # a PIZ file
  monkeypatch.setattr(pnative, "load", lambda: None)
  with pytest.raises(ValueError, match="PIZ EXR requires the native library"):
    pio.load_exr(path)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("tonemap", [False, True])
def test_png_bytes_and_arrays_equal_jax(tmp_path, flip, tonemap):
  img = _image(11, 13, seed=3) / 64.0
  got = pio.encode_png(img, flip=flip, tonemap=tonemap, exposure=1.5)
  assert got == jio.encode_png(img, flip=flip, tonemap=tonemap, exposure=1.5)
  p, j = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
  pio.save_png(p, img, flip=flip, tonemap=tonemap)
  jio.save_png(j, img, flip=flip, tonemap=tonemap)
  assert _bytes(p) == _bytes(j)
  assert np.array_equal(pio.decode_png(got), jio.decode_png(got))
  for srgb in (False, True):
    assert np.array_equal(pio.load_image(p, srgb), jio.load_image(p, srgb))


def _hdr_file(path, rle: bool):
  """A 3x9 Radiance HDR, flat RGBE or new-style run-length encoded rows."""
  h, w = 3, 9
  rs = np.random.default_rng(5)
  rgbe = rs.integers(0, 256, (h, w, 4), dtype=np.uint8)
  rgbe[..., 3] = rs.integers(120, 140, (h, w))
  rgbe[1, 2, 3] = 0  # a zero exponent: black
  body = b""
  for y in range(h):
    if not rle:
      body += rgbe[y].tobytes()
      continue
    body += bytes([2, 2, 0, w])
    for ch in range(4):
      row = rgbe[y, :, ch]
      # one run of the first byte over 3 texels, then the rest literally
      body += bytes([128 + 3, int(row[0])]) + bytes([w - 3]) + row[3:].tobytes()
      rgbe[y, 1:3, ch] = row[0]
  header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
  with open(path, "wb") as f:
    f.write(header + body)


@pytest.mark.parametrize("rle", [False, True])
def test_hdr_and_image_loaders_equal_jax(tmp_path, rle):
  path = str(tmp_path / "sky.hdr")
  _hdr_file(path, rle)
  got, want = pio.load_hdr(path), jio.load_hdr(path)
  assert got.shape == (3, 9, 4) and np.array_equal(got, want)
  assert np.array_equal(pio.load_image(path), jio.load_image(path))
  exr = str(tmp_path / "img.exr")
  jio.save_exr(exr, _image(6, 5), compression="zips")
  assert np.array_equal(pio.load_image(exr), jio.load_image(exr))
  rgba = np.concatenate([_image(4, 4) / 512.0, np.full((4, 4, 1), 0.5, np.float32)], -1)
  assert np.array_equal(pio.srgb_image_to_linear(rgba), jio.srgb_image_to_linear(rgba))
  with pytest.raises(ValueError, match="unsupported image format"):
    pio.load_image(str(tmp_path / "x.tga"))


def test_rmse_equals_jax():
  a, b = _image(), _image(seed=8)
  assert pio.rmse(a, b) == jio.rmse(a, b) and pio.rmse(a, a) == 0.0


def test_prefs_file_is_shared_with_jax(tmp_path, monkeypatch):
  monkeypatch.setenv("ETX_TPU_CONFIG_DIR", str(tmp_path / "cfg"))
  scenes = []
  for i in range(12):
    s = tmp_path / f"s{i}.json"
    s.write_text("{}")
    scenes.append(str(s))
  assert pprefs.prefs_path() == jprefs.prefs_path()
  pprefs.add_recent(scenes[0], integrator="vcm", spp=8)
  assert jprefs.recent_files() == [scenes[0]] and jprefs.load()["integrator"] == "vcm"
  jprefs.add_recent(scenes[1], integrator="pt")
  for s in scenes[2:]:
    pprefs.add_recent(s)
  pprefs.add_recent(scenes[5])  # moved to the front, not repeated
  got = pprefs.recent_files()
  assert got == jprefs.recent_files() and len(got) == 10
  assert got[0] == scenes[5] and got.count(scenes[5]) == 1 and scenes[0] not in got
  assert pprefs.load() == jprefs.load() and pprefs.load()["spp"] == 8
  # the same bytes on disk from either writer
  before = _bytes(pprefs.prefs_path())
  jprefs.save(pprefs.load())
  assert _bytes(jprefs.prefs_path()) == before
  # a missing scene drops out of the list; a corrupt file reads as empty
  (tmp_path / "s11.json").unlink()
  assert scenes[11] not in pprefs.recent_files()
  with open(pprefs.prefs_path(), "w") as f:
    f.write("{not json")
  assert pprefs.load() == {} == jprefs.load() and pprefs.recent_files() == []
  with open(pprefs.prefs_path(), "w") as f:
    json.dump([1, 2], f)
  assert pprefs.load() == {}
