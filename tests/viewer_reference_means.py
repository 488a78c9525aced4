"""Image means of the viewer's scene rendered on the CPU, the port's and
the JAX package's: the reference value of `chip_smoke.py`'s viewer gate
(VIEWER_MEAN is +-10% of the port's mean printed here).

    JAX_PLATFORMS=cpu python -m tests.viewer_reference_means [SIZE [SPP [WHICH]]]

Renders the scene of `cli view cornell` (the Cornell box with the
conductor tall box, path length 8) at SIZE x SIZE (default 64) and SPP
samples a pixel (default 16) by each package's pooled path tracer, as the
viewer accumulates it on the card at 512x512. Prints each image's mean and
the seconds it took. WHICH ("port", "jax", default both) picks the
packages.
"""

import sys
import time

import numpy as np
import torch


def main():
  size = int(sys.argv[1]) if len(sys.argv) > 1 else 64
  spp = int(sys.argv[2]) if len(sys.argv) > 2 else 16
  which = sys.argv[3] if len(sys.argv) > 3 else "both"
  torch.set_num_threads(4)
  if which in ("port", "both"):
    from etx_tracer_tpu_torch.models import path_tracing
    from etx_tracer_tpu_torch.scene import cornell
    t0 = time.perf_counter()
    scene, config = cornell.build_cornell_box(film_size=(size, size),
                                              max_path_length=8).build(device="cpu")
    img = path_tracing.render(scene, config, iterations=spp, device="cpu").camera.numpy()
    print(f"port {size}x{size} {spp} spp: mean {float(np.mean(img))!r} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
  if which in ("jax", "both"):
    import tests.conftest  # noqa: F401  (JAX on the CPU)
    from etx_tracer_tpu import native as jnative
    from etx_tracer_tpu_torch import native as pnative
    from etx_tracer_tpu.models import path_tracing as jpt
    from etx_tracer_tpu.scene import cornell as jcornell
    jnative.build_bvh_native = lambda *a, **k: None
    pnative.build_bvh_native = lambda *a, **k: None
    t0 = time.perf_counter()
    scene, config = jcornell.build_cornell_box(film_size=(size, size), max_path_length=8).build()
    img = np.asarray(jpt.render(scene, config, iterations=spp).camera)
    print(f"jax {size}x{size} {spp} spp: mean {float(np.mean(img))!r} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
  main()
