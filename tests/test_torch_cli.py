"""The port's command-line renderer against the JAX package's (CPU).

Both CLIs render the Cornell scene files that `scene/assets.py` writes at
16x16, path length 4 and 2 spp (tests/test_cli.py's settings), the port's
with `--device cpu`, and the EXRs are held pixel by pixel: path tracing at
tests/test_torch_render.py's tolerances (at most 2% of the pixels
off by more than 1e-4 + 1e-3 |ref|, means within 0.5%), the debug AOVs at
tests/test_torch_debug.py's (1e-5 on 98% of the pixels). The adaptive
render is held in tests/test_torch_adaptive.py, `--integrator vcm` in
tests/test_torch_cli_vcm.py. The other subcommands
(`compare`, `cornell`, `recent`, `--reference`) and the options of later
slices (`--devices N`, `view`), which raise, are checked here too.
"""

import json

import numpy as np
import pytest
import torch

from etx_tracer_tpu import cli as jcli
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu_torch import native as pnative
from etx_tracer_tpu.utils import image_io as jio
from etx_tracer_tpu_torch import cli as pcli
from etx_tracer_tpu_torch.scene import assets as passets
from etx_tracer_tpu_torch.utils import image_io as pio
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

ARGS = ["--size", "16x16", "--max-path", "4", "--spp", "2"]
OUTLIER_FRACTION = 0.02   # renders: pixels off by > 1e-4 + 1e-3 |ref|
MEAN_RTOL = 0.005
AOV_TOL = 1e-5            # debug AOVs, on all but OUTLIER_FRACTION of the pixels


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
  return passets.write_cornell_asset(str(tmp_path_factory.mktemp("cornell")))


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
  """A preferences folder of the test's own; the JAX side parses OBJ records
  in Python and builds the numpy BVH, as the port does."""
  monkeypatch.setenv("ETX_TPU_CONFIG_DIR", str(tmp_path / "cfg"))
  monkeypatch.setattr(jnative, "parse_obj_native", lambda *a, **k: None)
  monkeypatch.setattr(pnative, "parse_obj_native", lambda *a, **k: None)
  monkeypatch.setattr(jnative, "build_bvh_native", lambda *a, **k: None)


def _both(scene_file, tmp_path, *extra):
  """(port image, JAX image) of `cli render` with ARGS and `extra`."""
  j_out, p_out = str(tmp_path / "jax.exr"), str(tmp_path / "port.exr")
  jcli.main(["render", scene_file, "-o", j_out, *ARGS, *extra])
  pcli.main(["render", scene_file, "-o", p_out, *ARGS, *extra, "--device", "cpu"])
  got, want = pio.load_exr(p_out), jio.load_exr(j_out)
  assert got.shape == want.shape == (16, 16, 3) and np.isfinite(got).all()
  return got, want


def _outliers(got, want, atol, rtol):
  return (np.abs(got - want) > atol + rtol * np.abs(want)).any(axis=-1).mean()


def test_cli_render_matches_jax_cli(scene_file, tmp_path):
  got, want = _both(scene_file, tmp_path, "--integrator", "pt")
  assert _outliers(got, want, 1e-4, 1e-3) <= OUTLIER_FRACTION
  assert abs(got.mean() - want.mean()) <= MEAN_RTOL * abs(want.mean())
  assert got.mean() > 0.0


@pytest.mark.parametrize("aov", ["normals", "depth"])
def test_cli_debug_matches_jax_cli(scene_file, tmp_path, aov):
  got, want = _both(scene_file, tmp_path, "--integrator", "debug", "--aov", aov)
  assert _outliers(got, want, AOV_TOL, AOV_TOL) <= OUTLIER_FRACTION
  assert got.std() > 0.0


def test_cli_reference_compare_and_recent(scene_file, tmp_path, capsys):
  ref = str(tmp_path / "ref.exr")
  out = str(tmp_path / "out.exr")
  pcli.main(["render", scene_file, "-o", ref, *ARGS, "--integrator", "debug", "--device", "cpu"])
  capsys.readouterr()
  pcli.main(["render", "recent", "-o", out, *ARGS, "--integrator", "debug", "--device", "cpu",
             "--reference", ref])
  assert json.loads(capsys.readouterr().out) == {"rmse_vs_reference": 0.0}
  jio.save_exr(str(tmp_path / "other.exr"), np.full((16, 16, 3), 0.25, np.float32))
  for cli in (pcli, jcli):
    cli.main(["compare", out, str(tmp_path / "other.exr")])
  p_line, j_line = capsys.readouterr().out.splitlines()
  assert p_line == j_line and json.loads(p_line)["rmse"] > 0.0


def test_cli_cornell_png_and_lt_adaptive(tmp_path, capsys):
  png = str(tmp_path / "c.png")
  pcli.main(["cornell", "-o", png, "--size", "8x6", "--spp", "1", "--device", "cpu"])
  img = pio.load_png(png)
  assert img.shape == (6, 8, 4) and img[..., :3].max() > 0.0
  exr = str(tmp_path / "lt.exr")
  pcli.main(["render", passets.write_cornell_asset(str(tmp_path / "s")), "-o", exr,
             "--size", "8x8", "--max-path", "3", "--spp", "2", "--integrator", "lt",
             "--adaptive", "--device", "cpu"])
  assert "does not apply to the lt integrator" in capsys.readouterr().err
  assert pio.load_exr(exr).mean() > 0.0


def test_cli_later_slices_and_no_card_raise(scene_file, tmp_path, capsys):
  """`--devices 2` with `--device cpu` renders on two gloo ranks (the
  single-device render's image, but for the float order of sums); without a
  card `render` and `view` raise."""
  out = str(tmp_path / "x.exr")
  pcli.main(["render", scene_file, "-o", out, *ARGS, "--devices", "2", "--device", "cpu"])
  assert "2 gloo rank(s)" in capsys.readouterr().err
  single = str(tmp_path / "single.exr")
  pcli.main(["render", scene_file, "-o", single, *ARGS, "--device", "cpu"])
  np.testing.assert_allclose(pio.load_exr(out), pio.load_exr(single), rtol=1e-5, atol=1e-6)
  with pytest.raises(SystemExit):
    pcli.main(["render", scene_file, "--integrator", "nonsense"])
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match="device='cpu'"):
      pcli.main(["render", scene_file, "-o", out, *ARGS])
    with pytest.raises(RuntimeError, match="device='cpu'"):
      pcli.main(["view", scene_file])
