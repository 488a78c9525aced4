"""The port's native host library and what takes it, against the JAX
package's (CPU).

Both packages compile the same five C++ sources with g++ (the JAX package
into its own directory, the port under `etx_tracer_tpu_torch/_build/`,
named by a digest of the sources and flags). On the same inputs the two
libraries give the same BVH tree, array by array, the same OBJ records,
the same alias tables and the same PIZ bytes; a file that one package
writes, the other reads. NanoVDB grids written by the JAX-free writer
(`tests/nvdb_writer.py`) in the NONE, ZIP and BLOSC codecs read back equal
to the JAX package's reader. Where the library cannot be built, the port
takes its numpy or Python paths, as the JAX package does, and says which
builder staged a scene.
"""

import os

import numpy as np
import pytest

from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.ops import bvh_build as jbvh_build
from etx_tracer_tpu.scene import nvdb as jnvdb
from etx_tracer_tpu.scene import obj_loader as jobj
from etx_tracer_tpu.utils import image_io as jio
from etx_tracer_tpu_torch import native as pnative
from etx_tracer_tpu_torch.ops import bvh_build
from etx_tracer_tpu_torch.render import images as pimages
from etx_tracer_tpu_torch.scene import assets as passets
from etx_tracer_tpu_torch.scene import bigscene, cornell
from etx_tracer_tpu_torch.scene import nvdb as pnvdb
from etx_tracer_tpu_torch.scene import obj_loader as pobj
from etx_tracer_tpu_torch.scene import volumetric as pvol
from etx_tracer_tpu_torch.utils import image_io as pio
from tests import nvdb_writer
from tests.test_torch_images import load_native
from tests.test_torch_loaders import _write_scene
from tests.test_torch_trace import _tris


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
  load_native()
  assert pnative.load() is not None, pnative.failure()


def test_library_is_named_by_its_sources_and_flags(monkeypatch):
  """The library sits under `_build/` named by a digest of the sources and
  the flags; other flags name another library; `build` is a no-op once
  built."""
  path = pnative.library_path()
  assert path.parent == pnative.BUILD_DIR and path.exists()
  assert pnative.build() == 0.0
  monkeypatch.setattr(pnative, "CXX_FLAGS", pnative.CXX_FLAGS + ["-DETX_OTHER"])
  assert pnative.library_path() != path


@pytest.mark.parametrize("which", ["soup", "bigscene"])
def test_native_tree_equals_jax_native_tree(which):
  """The native builder's tree, every array (node_skip and fat_rows too),
  equals the JAX package's native tree; it holds every triangle once."""
  if which == "soup":
    v0, e1, e2 = _tris(np.random.default_rng(31), 3000)
  else:
    arrays, _ = bigscene.build_bigscene((16, 16)).arrays()
    v0, e1, e2 = (arrays[k] for k in ("tri_v0", "tri_e1", "tri_e2"))
  got, builder = bvh_build.build_tree(v0, e1, e2)
  want = jbvh_build.build_bvh(v0, e1, e2)
  assert builder == "native"
  assert set(got) == set(want)
  for name in want:
    assert got[name].dtype == want[name].dtype, name
    np.testing.assert_array_equal(got[name], want[name], err_msg=name)
  assert sorted(got["prim_index"].tolist()) == list(range(v0.shape[0]))
  assert bvh_build.tree_depth(got["node_left"], got["node_count"]) <= bvh_build.STACK_DEPTH
  numpy_tree = bvh_build.build_bvh_numpy(v0, e1, e2)
  assert not np.array_equal(numpy_tree["prim_index"], got["prim_index"])


def test_builder_falls_back_to_numpy_and_records_it(monkeypatch):
  """A scene records the builder that staged it: native when the library
  loads, numpy (the JAX package's numpy tree) when it does not."""
  b = cornell.build_cornell_box(film_size=(8, 8))
  b.arrays()
  assert b.bvh_builder == "native"
  monkeypatch.setattr(pnative, "load", lambda: None)
  b = cornell.build_cornell_box(film_size=(8, 8))
  arrays, _ = b.arrays()
  assert b.bvh_builder == "numpy"
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
  want = jbvh_build.build_bvh(arrays["tri_v0"], arrays["tri_e1"], arrays["tri_e2"])
  np.testing.assert_array_equal(arrays["bvh.prim_index"], want["prim_index"])
  assert pnative.piz_encode(b"\x00" * 24, [2, 2, 2], 1, 1) is None


def test_obj_parse_equals_jax(tmp_path):
  """`parse_obj_native` gives the JAX package's records on the Cornell
  scene files and on the directives scene (faces before a `usemtl`), and
  the port's loader freezes the JAX loader's tables through it."""
  cornell_obj = passets.write_cornell_asset(str(tmp_path / "c")).replace(".json", ".obj")
  for path in (cornell_obj, _write_scene(tmp_path)):
    got = pnative.parse_obj_native(os.path.abspath(path))
    want = jnative.parse_obj_native(os.path.abspath(path))
    assert set(got) == set(want)
    for key in want:
      if isinstance(want[key], np.ndarray):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
      else:
        assert got[key] == want[key], key
  pb = pobj.ObjSceneLoader().load(cornell_obj)
  jb = jobj.ObjSceneLoader().load(cornell_obj)
  assert pb.material_names == jb.material_names
  for a, b in zip(pb.positions, jb.positions):
    np.testing.assert_array_equal(a, b)


def test_alias_tables_equal_python_and_jax():
  rng = np.random.default_rng(5)
  p = (rng.random((40, 77)) ** 4).astype(np.float32)
  p[3] = 0.0
  got = pnative.build_alias_tables(p)
  for want in (jnative.build_alias_tables(p), pimages.alias_tables(p)):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("half", [False, True])
def test_piz_files_cross_packages(tmp_path, half):
  """A PIZ file of either package is the other's byte for byte and reads
  back in both; the flat half of the image compresses (PIZ blocks kept)."""
  img = np.random.default_rng(7).uniform(0.0, 3.0, (45, 70, 3)).astype(np.float32)
  img[:, :35] = 0.25
  p, j = str(tmp_path / "p.exr"), str(tmp_path / "j.exr")
  pio.save_exr(p, img, compression="piz", half=half)
  jio.save_exr(j, img, compression="piz", half=half)
  raw = open(p, "rb").read()
  assert raw == open(j, "rb").read()
  tag = b"compression\x00compression\x00"
  assert raw[raw.index(tag) + len(tag) + 4] == 4
  want = img.astype(np.float16).astype(np.float32) if half else img
  for got in (pio.load_exr(j), jio.load_exr(p)):
    np.testing.assert_array_equal(got, want[::-1])
  block = np.frombuffer(raw, np.uint8)
  assert block.size < img.size * (2 if half else 4)


@pytest.mark.parametrize("codec", [0, 1, 2])
def test_nvdb_equals_jax(tmp_path, codec):
  """A sparse grid of leaves and constant tiles, and bench config 4's dense
  cloud, in each codec (NONE, ZIP, BLOSC through the native decoder): the
  JAX package's grid, and the density loader reads the file."""
  path = str(tmp_path / "g.nvdb")
  nvdb_writer._single_leaf_file(path, codec=codec)
  np.testing.assert_array_equal(pnvdb.read_nvdb_density(path), jnvdb.read_nvdb_density(path))
  cloud = nvdb_writer.write_dense(str(tmp_path / "cloud.nvdb"), pvol._expected_grid(), codec)
  got = pobj.load_density_grid(cloud)
  np.testing.assert_array_equal(got, jnvdb.read_nvdb_density(cloud))
  np.testing.assert_array_equal(got, np.maximum(pvol._expected_grid(), 0.0))


def test_nvdb_blosc_zlib_and_errors(tmp_path):
  """The blosc decoder's zlib inner codec, a cleared degenerate grid, and
  an unsupported inner codec, as in the JAX package."""
  const = b"\x07" * 4096
  frame = nvdb_writer._blosc_frame(const, blocksize=1024, codec=3)
  assert pnative.blosc_decompress(frame, len(const)) == const
  bad = bytearray(nvdb_writer._blosc_frame(const, blocksize=1024))
  bad[2] = (bad[2] & 0x1F) | (4 << 5)
  with pytest.raises(ValueError, match="unsupported inner codec"):
    pnative.blosc_decompress(bytes(bad), len(const))
  flat = nvdb_writer.write_dense(str(tmp_path / "flat.nvdb"), np.full((8, 8, 8), 0.75), codec=2)
  assert pnvdb.read_nvdb_density(flat) is None and jnvdb.read_nvdb_density(flat) is None
