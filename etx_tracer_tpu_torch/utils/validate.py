"""The validating build: finite checks after each integrator stage.

Counterpart of `etx_tracer_tpu/utils/validate.py` (the reference's
ETX_VALIDATE guards). A configuration with `SceneConfig.validate` set makes
`models/path_tracing.pt_step` and the VCM passes call `check_finite` after
each stage; the first stage whose values are not finite raises
`ValidationError` naming it ("non-finite in pt:bsdf_sample:weight"). A
check reads the host once, so only a validating build pays for it: with
`validate` unset no check is called and the bounce launches exactly the
kernels it launches without this module.
"""

from __future__ import annotations

import torch


class ValidationError(RuntimeError):
  """A stage of a validating build produced a non-finite value."""


def check_finite(tag: str, **arrays: torch.Tensor) -> None:
  """Raise ValidationError "non-finite in <tag>:<field>" for the first
  field, in argument order, with a value that is not finite (one host read
  when every field is finite)."""
  finite = torch.stack([torch.isfinite(a).all() for a in arrays.values()])
  if finite.all().item():
    return
  bad = list(arrays)[finite.tolist().index(False)]
  raise ValidationError(f"non-finite in {tag}:{bad}")
