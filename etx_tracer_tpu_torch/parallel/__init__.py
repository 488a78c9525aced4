"""Sharded rendering over several ranks: the film's rows across processes
(`mesh.py`), counterpart of `etx_tracer_tpu/parallel`."""

from etx_tracer_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, launch, make_mesh, render_iteration_sharded, render_samples_sharded,
    vcm_render_iteration_sharded)
