"""Integrators: `path_tracing` (the pooled wavefront path tracer with NEE
and MIS) and `vcm` (VCM, with BDPT, BDPTFast and light tracing as its
option sets). Both render the Diffuse, Conductor, Dielectric, Thinfilm and
Boundary classes in RGB or spectral mode, with media and subsurface
scattering, lit by area emitters. Environment and directional emitters,
the other material classes, textures, `models/debug.py` and multi-device
rendering are later slices (ROADMAP Queue 1)."""
