"""Showcase subset B by full VCM, the port against the JAX package (CPU).

Subset B of the all-classes showcase (`tests/shading_showcase.py`,
test_torch_showcase_b.py): the Velvet, the Translucent and the two
rough-diffuse variations, rendered by VCM (light paths, vertex
connections, merging) from iteration 1 for 4 iterations at 16x16, each
package's film from zero. With a diffuse variation present every Diffuse
lane merges through the BSDF dispatch, which examines the first 32
photons of each cell in the order of a hash of their positions' last bits
(ROADMAP Queue 3, "The capped merge reads the last bit of a position"):
the jitted JAX code rounds some light vertices apart from its eager form
and from the port, so a cell holding more photons would pick other ones.
The merge radius is set to MERGE_RADIUS, which keeps every cell at or
below 32 photons (the test checks it on the port's light passes), and the
photon cap above every occupancy.

The walk lanes part as in test_torch_showcase_b.py (an ulp of acos,
atan2, sin or cos in its microfacet normal sends a lane's walk elsewhere),
but VCM evaluates the variation-1 lobe at every vertex connection and for
every merged photon, a walk each: more of its lanes meet a parted walk.
Rendered without the walk's material, the VCM images agree in every
pixel; with it, VCM_WALK_OUTLIERS of the 256 pixels may be outliers (39
measured), the image mean agrees within the walk renders' 0.5% and the
rays within 1%.
"""

import numpy as np
import torch

from etx_tracer_tpu.models import vcm as jvcm
from etx_tracer_tpu.render import film as jfilm
from etx_tracer_tpu_torch.models import vcm as pvcm
from etx_tracer_tpu_torch.render import film as pfilm
from tests.test_torch_showcase_a import FILM, FIRST, SPP
from tests.test_torch_showcase_b import check_walk_render, subset_b  # noqa: F401
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

UNCAPPED = 1 << 20    # photons a merge cell keeps: above every occupancy
MERGE_RADIUS = 0.1    # every cell holds at most the glossy pass's 32 photons
VCM_WALK_OUTLIERS = 48


def test_subset_b_vcm_render_matches_jax_pixel_by_pixel(subset_b):
  jscene, jconfig, pscene, pconfig, _ = subset_b
  options = pvcm.VCMOptions(max_photons_per_cell=UNCAPPED, initial_radius=MERGE_RADIUS)
  jo = jvcm.VCMOptions(max_photons_per_cell=UNCAPPED, initial_radius=MERGE_RADIUS)
  pf, jf = pfilm.allocate(*FILM, "cpu"), jfilm.allocate(*FILM)
  rays = jrays = 0
  for it in range(FIRST, FIRST + SPP):
    radius, vcw, vmw, _ = pvcm.radius_schedule(pscene, pconfig, options, it)
    verts, _, state = pvcm.light_pass(pscene, pconfig, options, it, FILM[0] * FILM[1],
                                      float(vcw), float(vmw))
    grid = pvcm.build_merge_grid(pscene, verts, state.wl, float(radius), True, UNCAPPED)
    occupancy = torch.unique_consecutive(grid.sorted_cell[grid.valid], return_counts=True)[1]
    assert 1 < int(occupancy.max()) <= pvcm._MERGE_SCAN
    pf, r = pvcm.render_iteration_stats(pscene, pconfig, options, pf, it, device="cpu")
    jf, jr = jvcm.render_iteration_stats(jscene, jconfig, jo, jf, it)
    rays, jrays = rays + int(r), jrays + float(jr)
  img, ref = pfilm.result_image(pf).numpy(), np.asarray(jfilm.result_image(jf))
  check_walk_render(img, ref, rays, jrays, outliers=VCM_WALK_OUTLIERS)
  assert (np.abs(img).sum(axis=-1) > 0).mean() > 0.9
