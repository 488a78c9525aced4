"""Integrators: `path_tracing` (the pooled wavefront path tracer with NEE
and MIS, and its per-iteration, scatter-pool, mapped and adaptive drivers),
`vcm` (VCM, with BDPT, BDPTFast and light tracing as its option sets) and
`debug` (the 18 AOVs). They render every material class in RGB or
spectral mode, with media and subsurface scattering, lit by area,
environment and directional emitters; `parallel/mesh.py` shards them over
ranks."""
