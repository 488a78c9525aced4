"""Shared pytest fixtures of the port's tests that compare with the JAX package.

`port_numpy_tree`: an autouse, module-scoped pin of the port's BVH builder
to numpy for a whole test module (import it into the module). The port,
like the JAX package, builds its trees with the native library when g++
can build it; the two builders' trees differ in every array, and the
comparisons with the JAX package pin its builder to numpy
(`etx_tracer_tpu.native.build_bvh_native`), so the port's scenes, staged in
any fixture of the module, must take the numpy tree too.
"""

import pytest

from etx_tracer_tpu_torch import native as pnative


@pytest.fixture(scope="module", autouse=True)
def port_numpy_tree():
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(pnative, "build_bvh_native", lambda *a, **k: None)
    yield
