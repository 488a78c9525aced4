"""Image means of the media slice's CPU renders, the port's and the JAX
package's, at 64x64: the reference values of `chip_smoke.py`'s volumetric
and subsurface gates (VOLUMETRIC_MEAN, SUBSURFACE_MEAN are +-10% of the
port's).

    JAX_PLATFORMS=cpu python -m tests.media_reference_means

Renders bench config 4 (`scene/volumetric.volumetric`, 8 spp) and
test_sss_render's configuration (`scene/volumetric.subsurface_cornell`,
random walk, 4 spp) through both packages' `render` from iteration 0, the
JAX tree built by its numpy builder, and prints each mean and the seconds
it took (about a minute in all on 4 CPU threads). The cloud's `.vol` file
goes to $XDG_CACHE_HOME (default ~/.cache).
"""

import time

import numpy as np
import torch

import tests.conftest  # noqa: F401  (JAX on the CPU)
from benchmarks import scenes as jscenes
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu_torch import native as pnative
from etx_tracer_tpu.models import path_tracing as jpt
from etx_tracer_tpu.render import film as jfilm
from etx_tracer_tpu_torch.models import path_tracing as ppt
from etx_tracer_tpu_torch.render import film as pfilm
from etx_tracer_tpu_torch.scene import volumetric as pvol
from tests.test_torch_subsurface import RW, _jax_subsurface

SIZE = (64, 64)


def main():
  torch.set_num_threads(4)
  jnative.build_bvh_native = lambda *a, **k: None
  pnative.build_bvh_native = lambda *a, **k: None
  cases = (("volumetric", jscenes.volumetric(SIZE), pvol.volumetric(SIZE), 8),
           ("subsurface", _jax_subsurface(SIZE, RW), pvol.subsurface_cornell(SIZE, RW), 4))
  for name, jb, pb, spp in cases:
    t0 = time.perf_counter()
    scene, config = pb.build(device="cpu")
    img = pfilm.result_image(ppt.render(scene, config, iterations=spp, device="cpu")).numpy()
    print(f"{name} {SIZE[0]}x{SIZE[1]} {spp} spp: port (CPU) mean {float(img.mean())!r} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    scene, config = jb.build()
    img = np.asarray(jfilm.result_image(jpt.render(scene, config, iterations=spp)))
    print(f"{name} {SIZE[0]}x{SIZE[1]} {spp} spp: JAX (CPU) mean {float(img.mean())!r} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
