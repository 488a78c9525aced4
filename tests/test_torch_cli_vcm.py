"""The port's `cli render --integrator vcm` against the JAX CLI (CPU).

Both CLIs render the Cornell scene files at 16x16, path length 4 and 2
iterations (tests/test_torch_cli.py's settings). A merge cell over its
photon cap keeps photons in the order of a hash of their position bits, so
two renders that round one light vertex apart merge different photons
(ROADMAP Queue 3, watch list): both CLIs run here with the options of a
cap above every cell's occupancy (`max_photons_per_cell=1 << 20`, as
tests/test_torch_vcm.py compares), set through each package's
`VCMOptions`. The EXRs are held pixel by pixel at
tests/test_torch_render.py's tolerances (at most 2% of the pixels off by
more than 1e-4 + 1e-3 |ref|, means within 0.5%).
"""

import functools

from etx_tracer_tpu.models import vcm as jvcm
from etx_tracer_tpu_torch.models import vcm as pvcm
from tests.test_torch_cli import _both, _outliers, isolated, scene_file  # noqa: F401

UNCAPPED = 1 << 20
OUTLIER_FRACTION = 0.02
MEAN_RTOL = 0.005


def test_cli_vcm_matches_jax_cli(scene_file, tmp_path, monkeypatch):  # noqa: F811
  monkeypatch.setattr(jvcm, "VCMOptions",
                      functools.partial(jvcm.VCMOptions, max_photons_per_cell=UNCAPPED))
  monkeypatch.setattr(pvcm, "VCMOptions",
                      functools.partial(pvcm.VCMOptions, max_photons_per_cell=UNCAPPED))
  got, want = _both(scene_file, tmp_path, "--integrator", "vcm")
  assert _outliers(got, want, 1e-4, 1e-3) <= OUTLIER_FRACTION
  assert abs(got.mean() - want.mean()) <= MEAN_RTOL * abs(want.mean())
  assert got.mean() > 0.0
