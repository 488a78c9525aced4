"""Smoke test of the PyTorch/CUDA port (`etx_tracer_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each with its elapsed seconds:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel source of the port (`csrc/`), one
     process per source, all started together, and reports each kernel's
     registers, spills and stack frame;
  3. K1 closest hit and 4. K2 any hit: each kernel against its plain PyTorch
     version on the card, on 2^18 rays against the Cornell triangles and a
     random 128-triangle soup, and on 2^16 rays against the materials
     scene's 996 triangles and bigscene's 15,396 (the kernels take any
     count; the dispatch sends them at most 128), with and without masked
     rows; rays include axis-parallel ones, rays aimed at shared edges and
     vertices, and rays with t_max = -1; on the tables of at most 1,024
     triangles also under the eight lane patterns of phase 5. Times each
     kernel and its plain version at 2^18 rays x 36 triangles, and K1's at
     2^16 rays x 15,396, with each launch's blocks per SM, rays a block and
     waves; then holds both
     against their plain versions on narrow batches of 2^12, 2^14 and 2^16
     live rays against the Cornell triangles and times them there, with
     their launch shape;
  5. K3 pair-tile closest hit and 6. K4 pair-tile any hit: the same checks
     on 2^18 rays against the materials scene's 996 triangles, random
     4096- and 4097-triangle soups, a 129-triangle soup, the Cornell
     triangles and bigscene's 15,396, and on 2^16 of those rays under eight
     lane patterns (every other lane dead, all dead, one live ray per warp,
     t_max == t_min, t_min = t_max = 0, a NaN t_min on every third lane,
     t_min one ulp above t_max on every other lane, strided rays); timed,
     with the plain version, at 2^18 rays x 996 triangles, K3 also x 15,396,
     with each kernel's blocks per SM and waves;
  7. K5 fat-row BVH closest hit and 8. K6 fat-row any hit, then 9. K7
     plain-node BVH closest hit and 10. K8 plain-node any hit: the same
     checks on 2^18 rays against bigscene's tree (15,396 triangles, origins
     inside the room) and the tree of a random 5000-triangle soup, and on
     2^16 rays against a comb 61 levels deep (its fat walk pushes 60 stack
     entries), with and without masked rows, and on 2^14 of those rays under
     the eight lane patterns; K7/K8 walk the same trees without their fat
     rows. Timed at 2^18 rays against bigscene; each bound counts the box
     and triangle tests the plain version's walk makes for the rays whose
     interval is not empty; a per-ray work line gives the plain walk's rows
     and triangle tests a ray (mean, p99, max) and the share of lane slots
     that carry a step when one thread walks one ray; each also prints its
     blocks per SM and grid;
  11. K9a Woop closest hit and 12. K9b Woop any hit: the same checks on
     2^18 rays against the materials (996), caustics (1,060) and bigscene
     (dense, 15,396) scenes and the 4096- and 129-triangle soups, and on
     2^16 of those rays under the eight lane patterns (all but bigscene);
     timed, with the plain version, at 2^18 rays x 996 triangles, K9a also
     x 15,396, with each launch's blocks per SM and waves; then both held
     against their plain versions and timed on narrow batches of 2^12 and
     2^14 live rays against the materials scene; then, for comparison only,
     the time of the FP32 `torch.matmul` of the
     (R, 8) x (8, 6 x 512) products that the TPU kernel hands to its matrix
     unit;
  13. main path, Cornell: the diffuse Cornell box at 512x512, max path
     length 1023, a 2^18-lane pool and 64 iterations through
     `render_samples_static` and `finalize_film` (what `path_tracing.render`
     runs), with every kernel launch counted; then one iteration of it under
     the profiler, to show where a bounce's time goes and each trace
     kernel's device time per launch; then the closest-hit and shadow rays
     of bounce 2 of one more iteration, captured as the main path traces
     them (dead lanes at t_max = 0), with K1 and K2 held against their plain
     versions and timed on them, beside their live share and bound;
  14. main path, materials: the spectral materials showcase (996 triangles:
     Diffuse, Conductor, Dielectric and Thinfilm) at 512x512, max path
     length 16, a 2^18-lane pool and 4 iterations, counted and profiled the
     same way; then the closest-hit and shadow rays of bounce 2 of one more
     iteration, captured as the main path traces them (dead lanes at
     t_max = 0), with K3 and K4 held against their plain versions and timed
     on them, beside their live share and bound;
  15. main path, bigscene: twelve icospheres in the Cornell box (15,396
     triangles, Diffuse, RGB) at 512x512, max path length 8, a 2^18-lane
     pool and 8 iterations, traced by K5/K6, counted and profiled the same
     way; then its bounce-2 rays captured as the materials path's are, with
     K5 and K6 held against the plain walk and timed on them, beside their
     live share, bound and per-ray work;
  16. main path, bigscene without fat rows: the same render of the same
     scene with its tree's fat rows removed, so the trace dispatch takes
     K7/K8 (and never K5/K6), gated as phase 15 and held against phase 15's
     image (exact ties may go to other triangles), profiled, and its
     bounce-2 rays captured, with K7 and K8 held against the plain walk and
     timed on them; the `kernels` line's K7/K8 launches are this render's;
  17. main path, volumetric: the JAX package's bench config 4 (the diffuse
     Cornell box in a heterogeneous 24^3 cloud written as a `.vol` file and
     loaded back; `scene/volumetric.volumetric`) at 384x384, max path
     length 10, a 2^18-lane pool and 8 iterations through the non-deferred
     bounce: free-path sampling, NEE through `_trace_transmittance`, every
     trace through K1 (no shadow ray reaches K2); gated like the others,
     profiled (bounces, kernels and host reads a bounce, device busy share),
     and the rays of the first `_trace_transmittance` segment of bounce 2
     captured, with K1 held against its plain version and timed on them;
  18. main path, subsurface: `tests/test_media.py::test_sss_render`'s
     configuration (the gray material random-walk SSS;
     `scene/volumetric.subsurface_cornell`) at 384x384, max path length 6,
     a 2^18-lane pool and 2 iterations, gated, timed and profiled, with K1's
     launches a bounce inside the walk;
  19. main path, caustics VCM: the JAX package's bench config 5 (the glass
     torus over the Cornell floor, 1,060 triangles; `scene/caustics`) at
     256x256, spectral, max path length 16, by full VCM (`models/vcm.py`,
     default options: connections, merging with 16 photons a cell, 65,536
     light paths an iteration): iteration 0 warms up, iterations 1-2 are
     timed through `render_iteration_stats` (seconds and rays an
     iteration, Mrays/s), every trace through K3/K4; gated (finite, the
     light layer's luminance >= 0 and the image's mean luminance > 0, mean
     within +-10% of the port's 128x128 CPU render, red left third, green
     right third) and one more iteration, at 128x128, profiled (bounces of
     both passes, kernels and host reads, device busy share); then camera
     step 1 of one more 256x256 iteration captured as the main path runs
     it: K3 on its closest-hit rays (65,536) and K4 on its (R*V)-wide
     vertex connection batch (524,288), each held bit-equal against its
     plain version and timed beside its bound; the capped merge grid
     (16 photons a cell) built on the card and again on the CPU from the
     same light vertices, held bit-equal (the throughput's RGB within
     1e-5 of each photon's largest channel), and that step's
     `merge_gather` run again on the CPU on the CPU's grid, within 1e-5
     of each lane's largest channel on 99.9% of the lanes and 1e-4 on
     all;
  20. main path, volumetric BDPT: bench config 4 (the cloud) at 256x256,
     max path length 10, by BDPT, timed, gated (>= 0, mean within +-10% of
     the port's 128x128 CPU render) and profiled at 256x256, every trace
     (the transmittance walks of connections and NEE included) through K1;
     then K1 on camera step 1's closest-hit rays and on the first segment
     of its (R*V)-wide transmittance walk, captured, held bit-equal and
     timed as in phase 19;
  21. main path, atmosphere: the JAX package's bench config 3
     (`scene/atmosphere.atmosphere_scene`: a ground quad and an open box,
     12 Diffuse triangles, under a Directional sun and an Environment sky
     whose 256x128 image and 64x64 sun disk the host marches in numpy,
     seen through a thin lens) at 512x512, spectral, max path length 8, a
     2^18-lane pool, by `bench.py:_pt_mrays`'s protocol (8 warm iterations,
     then 1 timed repetition of 8): staging, warm-up and timed seconds,
     rays, Mrays/s and K1/K2 launches; gated (finite, no negative
     luminance, mean luminance within +-10% of the port's 128x128 CPU
     render); profiled as phase 13's path is; then K1 and K2 on the
     closest-hit and shadow rays of its bounce 2, captured, held bit-equal
     to their plain versions and timed beside them and their bounds;
  22. end to end: the golden 32x32 Cornell render (max path length 6, 4 spp)
     on the card against the same render on the CPU and the JAX package's
     recorded golden values; the 32x32 materials render (4 spp) on the card
     against the same render on the CPU; the 32x32 bigscene render (8 spp)
     on the card against the CPU, through K5/K6, and again with the tree's
     fat rows removed, through K7/K8; the 32x32 volumetric (4 spp),
     random-walk and Christensen-Burley SSS (2 spp each) and fog with a
     Boundary cube and a radiance clamp (4 spp) renders on the card against
     the CPU; and the VCM slice's 32x32 renders on the card against the CPU:
     VCM (without the per-cell cap, 2 iterations) and light tracing (4) on
     the diffuse Cornell box, caustics VCM (spectral, without the cap, 1
     iteration, through K3/K4) and volumetric BDPT (2 iterations, through
     K1); and the image slice's: VCM (without the cap) and BDPT on the
     environment-lit floor (4 iterations), a Cornell box through a lens
     shaped by an image and bench config 3 (its staged sky, spectral) by
     path tracing (4 spp each), all through K1/K2;
     and the shading slice's: the all-classes showcase by path tracing with
     blue noise (1 spp) and by VCM (without the per-cell cap, at a merge
     radius that keeps every cell within the glossy merge's 32 photons,
     path length 4, 1 iteration), both through K3/K4, and the specular-box
     Cornell (a glass
     tall box, a mirror short box) by path tracing (4 spp, K1/K2);
  22b. main path, shading showcase (run before phase 22): the all-classes
     showcase (`tests/shading_showcase.py`: nine icospheres of order 2 in
     the spectral Cornell box lit by a 4000 K white LED, one each of the
     textured Plastic, Velvet, Translucent, Principled with metalness,
     roughness and normal-map images, Mirror, the two rough-diffuse
     variations, Void and an alpha-cut Diffuse; 2,916 triangles) at
     512x512, max path length 16, a 2^18-lane pool, blue noise, by
     `_pt_mrays`'s protocol shortened to 1 warm iteration and 1 timed
     repetition of 1: staging, warm-up and timed seconds, rays, Mrays/s
     and K3/K4 launches (every trace through K3/K4); gated (finite, no
     negative luminance, mean luminance within +-10% of the port's 64x64
     CPU render); then K3 and K4 on the closest-hit and shadow rays of its
     bounce 2, captured, held bit-equal to their plain versions and timed
     (its kernels a bounce are in PERF.md §5);
  22c. the CLI (run before phase 22): the Cornell scene files that
     `scene/assets.py` writes (the Cornell box with the silver tall box, 36
     triangles, 640x640, 32 spp, path length 1023): `python3 -m
     etx_tracer_tpu_torch.cli render --spp 16` in a subprocess (path
     tracing through K1/K2; its launch counts from its log), then
     `cli.main` with `--adaptive --spp 48` (32 warm spp by the scatter
     pool, then two batches of 8 over the active-pixel map) and with the normals and
     albedo AOVs (one K1 launch each), the launch counts set to 0 before
     each and read after; each EXR read back with `utils/image_io` and
     gated (finite, >= 0, red left third, green right third, mean within
     +-10% of the port's 64x64 CPU render); the seconds, rays and active
     pixels of each batch printed; then `active_pixel_map` card against
     CPU on the CPU's 32 warm spp of the files at 32x32 (equal maps), and
     one mapped batch of 8 spp from that map and those sums on both,
     within the end-to-end tolerances;
  22d. the sharding slice (run before phase 22): `python3 -m
     etx_tracer_tpu_torch.cli render --devices 2 --spp 8` on the Cornell
     scene files in a subprocess (one card is visible: the CLI says so and
     runs a NCCL world of 1), gated as 22c's PT; `python3 -m
     etx_tracer_tpu_torch.cli view cornell --size 512x512` in a subprocess,
     driven over HTTP (the first frame, 3 iterations, the result saved as
     EXR and gated against the port's CPU mean, four layers as PNGs, an
     orbit's 8x8-block preview and the restart, VCM), its launches from its
     `/status`; the main path's Cornell (512x512, path length 1023, 8 spp)
     by `parallel/mesh.render_samples_sharded` on 3 gloo ranks that share
     the card (512 rows pad to 513; gloo's collectives on CUDA tensors
     probed first) and on a NCCL world of 1, each held against the
     single-device render of the same samples within the end-to-end
     tolerances and gated, with each rank's seconds, rays and launches and
     the seconds to spawn and join the ranks; bench config 5 by VCM on 2
     gloo ranks sharing the card (one uncapped 32x32 iteration against the
     single-device one, then 2 capped iterations at 256x256 gated as phase
     19); the validating build on a 64x64 Cornell (launches and bounces
     equal to the production build's, its extra seconds and host reads a
     bounce; a NaN reflectance raises naming a `pt:` stage);
  23. micro: the micro-benchmark entry
     (`etx_tracer_tpu_torch/benchmarks/micro.py`) runs its four trace
     groups at full width (`trace`: K5 and K1 on 2^16 rays of three kinds
     against bigscene; `trace_brute`: K3/K4 against K9a/K9b on 2^18 random
     rays against materials, caustics and bigscene; `trace_sorted` and
     `trace_oracle`: K5 on sorted rays) and prints its lines, with the launch
     counts set to 0 before each group and read after; checks that K5 and
     K1 give equal t, that sorted rays get their unsorted hits, and prints
     K9a's agreement with K3 (the share of equal `tri`, the largest relative
     |dt|). K9a/K9b's launches in the `kernels` line are `trace_brute`'s.
     Then its other four groups, each checked to launch what it should:
     `sort` and `mxu` (no kernel of the port), `dispatch` (the materials
     scene's first hits at 256x256, one K3) and `step` (the phases of a
     bounce of bench config 2 at 512x512, K3/K4);
  24. the walks (`lobes.MS_BACKEND = "walk"`): the shading showcase at
     512x512 under the Heitz walks (its Principled material walks the
     conductor, dielectric and plastic lobes, its Plastic the plastic one),
     1 warm and 1 timed spp through K3/K4, gated (finite, no negative
     luminance, mean luminance within +-10% of the port's walked 64x64 CPU
     render), its first bounce at 128x128 profiled (kernels and host reads,
     beside the LUT showcase's first bounce), then the walked showcase (1
     spp) and the walked materials scene (4 spp, its rough gold conductor
     walks) at 32x32 card against CPU;
  25. NanoVDB: bench config 4's 24^3 cloud written as a BLOSC `.nvdb` by
     the JAX-free writer `tests/nvdb_writer.py` and read back equal; the
     Cornell scene files with that grid as a medium (the camera and every
     material in it) rendered by `python3 -m etx_tracer_tpu_torch.cli
     render` in a subprocess at 384x384, 8 spp, path length 10, through K1,
     and with the grid as a `.vol` by `cli.main`: equal images;
  26. the native library: g++ and zlib.h reported, the library built
     (the phase fails if it does not); bigscene's tree built natively and
     by numpy, K5-K8 held bit-equal to their plain walks on the native tree
     and timed on both; the CLI's Cornell OBJ files parsed natively,
     freezing the Python parse's tables; a PIZ EXR round trip (FLOAT and
     HALF). Every staged main-path scene says which builder built its BVH
     (the native one wherever the library builds);
  27. `benchmarks/denoise_eval` with its ground truth cut to 1,024 spp:
     MSE and SSIM of the a-trous denoiser at 4 and 32 spp, gated finite and
     reducing the interior MSE.

Any failed check raises, so the script exits non-zero. After every phase has
passed it prints one JSON line with each kernel's numbers and, as its last
line, {"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
and prints no result. The script imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from etx_tracer_tpu_torch import cli, native
from etx_tracer_tpu_torch.core import spectrum
from etx_tracer_tpu_torch.models import path_tracing, vcm
from etx_tracer_tpu_torch.benchmarks import denoise_eval, micro
from etx_tracer_tpu_torch.ops import _build, brute2_trace, brute_trace, bvh_build, bvh_trace
from etx_tracer_tpu_torch.ops import woop_trace
from etx_tracer_tpu_torch.parallel import mesh as pmesh
from etx_tracer_tpu_torch.render import film as film_mod
from etx_tracer_tpu_torch.render.bsdf import lobes
from etx_tracer_tpu_torch.scene import assets, atmosphere, bigscene, caustics, cornell
from etx_tracer_tpu_torch.scene import json_scene, materials, nvdb
from etx_tracer_tpu_torch.scene import volumetric
from etx_tracer_tpu_torch.scene import packed
from etx_tracer_tpu_torch.scene import builder as scene_builder
from etx_tracer_tpu_torch.scene import spectral_data
from etx_tracer_tpu_torch.scene import types as scene_types
from etx_tracer_tpu_torch.utils import image_io, validate

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# FP32 adds, subtracts and multiplies per ray-triangle pair (Woop: 18 for
# w = A o + b, 15 for q = A d, the division, 4 for u and v, 1 for u + v)
FLOPS_PER_PAIR = {brute_trace: 44, brute2_trace: 48, woop_trace: 39}
# bytes of one triangle as the kernel reads it: v0, e1, e2 (K1-K4) or a
# 12-float Woop row (K9a/K9b)
TRI_BYTES = {brute_trace: 36, brute2_trace: 36, woop_trace: 48}
# ... per BVH triangle test (`_tri_hit`: 45 and a division) and per box
# slab test (12 for the three slabs, 2 for the conservative far bound; the
# 12 min/max and the compares not counted), from csrc/bvh_trace.cu
FLOPS_PER_BVH_TRI = 45
FLOPS_PER_BOX = 14

# the JAX package's golden values for the 32x32 render (tests/test_golden.py)
GOLDEN_MEAN = np.array([0.12571028, 0.05596193, 0.00888113])
GOLDEN_TOTAL = 195.1266
GOLDEN_RTOL = 2e-3

# kernel vs plain version: the same arithmetic in the same order, built with
# -fmad=false, so bit-equal results are expected; the check allows t, u, v
# to differ by this much relative to max(1, |value|), and tri not at all
KERNEL_ATOL = 1e-6

RAYS = 1 << 18
# rays of a K1/K2 check case against thousands of triangles (the plain
# versions test every pair: about a second a call at 2^16 x 15,396)
FEW_RAYS = 1 << 16
# rays of a BVH kernel's lane patterns: the plain walk's time grows with its
# longest walk, about a second a call on the card
BVH_LANE_RAYS = 1 << 14
# K1/K2's lane patterns run on tables of at most this many triangles
BRUTE_LANE_TRIS = 1024
# ... and K9a/K9b's on tables of at most this many (all but bigscene's)
WOOP_LANE_TRIS = 4096
# the narrow batches K1/K2 are held and timed on: the cascade's phase widths
NARROW = (1 << 12, 1 << 14, 1 << 16)
# ... and K9a/K9b's, against the materials scene
WOOP_NARROW = (1 << 12, 1 << 14)
ITERATIONS = 64  # Cornell main-path samples per pixel: one chunk of the JAX package's bench
# materials main path: one `_pt_mrays` call of the JAX package's bench at half
# its 8 iterations
MATERIALS_ITERATIONS = 4
# the materials image mean at 512x512, 8 spp must lie in this range: the
# port's CPU render of the scene in tests/test_torch_materials.py (16x16,
# 2 spp) has mean 0.0666, and that test holds it inside this range, which is
# that mean +-10%
MATERIALS_MEAN = (0.060, 0.0733)
# card vs CPU, end to end: the tolerances the CPU tests hold the port to
# against the JAX package (tests/test_torch_render.py, test_torch_materials.py)
E2E_OUTLIERS = 0.02
E2E_MEAN_RTOL = 0.005
# bigscene main path: one `_pt_mrays` call of the JAX package's bench
BIGSCENE_ITERATIONS = 8
# the bigscene image mean at 512x512, 8 spp must lie in this range: the
# port's CPU render of the scene at 64x64, 16 spp has mean 0.06337 (and at
# 32x32, 8 spp 0.06316); tests/test_torch_bigscene.py holds that 64x64 mean
# inside this range, which is 0.06337 +-10%
BIGSCENE_MEAN = (0.0570, 0.0697)
# the materials main path's bounce whose rays K3/K4 are held and timed on
CAPTURE_BOUNCE = 2
# volumetric main path (bench config 4): its film and one `_pt_mrays` call
# of the JAX package's bench
VOLUMETRIC_SIZE = (384, 384)
VOLUMETRIC_ITERATIONS = 8
# the volumetric image mean at 384x384, 8 spp must lie in this range: the
# port's CPU render of the scene at 64x64, 8 spp has mean 0.020675
# (`python -m tests.media_reference_means`; the JAX package's 0.020675), and
# this range is that mean +-10%
VOLUMETRIC_MEAN = (0.01861, 0.02274)
# subsurface main path: test_sss_render's configuration at the volumetric
# film, 2 iterations (the test's 4, halved)
SUBSURFACE_ITERATIONS = 2
# ... and its mean: the port's CPU render at 64x64, 4 spp, 0.065555 (the same
# script; the JAX package's 0.065557), +-10%
SUBSURFACE_MEAN = (0.05900, 0.07211)
# VCM slice main paths, the JAX package's bench configs 5 (caustics, full
# VCM, spectral) and 4 (the cloud, BDPT) at the bench's film, through
# `models/vcm.py`: iteration 0 warms up, iterations 1..VCM_TIMED are timed
# (`bench.py:_vcm_iter_stats`)
VCM_SIZE = (256, 256)
VCM_TIMED = 2
# their image means after iterations 0..VCM_TIMED must lie in these ranges:
# the port's CPU render of each path at 128x128 and as many iterations
# (`python -m tests.vcm_reference_means 128`), +-10%: caustics VCM 0.070216,
# volumetric BDPT 0.020555. At 64x64 the means are 0.063049 (the merge
# radius, 4x the 256x256 one, darkens the caustics) and 0.018293 (16,384
# BDPT paths of the cloud; path tracing at 64x64 and 8 spp gives 0.020675)
CAUSTICS_VCM_MEAN = (0.06319, 0.07724)
VOLUMETRIC_BDPT_MEAN = (0.01850, 0.02261)
# the camera step whose rays the VCM-family captured phases hold the
# kernels on: the first bounce after the camera rays' hits, while the
# camera pass still runs at its full width (65,536 lanes; its cascade
# narrows only once at most a quarter of them live)
VCM_CAPTURE_STEP = 1
# the card's merge grid and merge against the CPU's, by a row's largest
# difference over its largest |value| (`row_rel_diff`): every photon's
# throughput RGB within MERGE_RTOL; the merged RGB within MERGE_RTOL on
# MERGE_SHARE of the lanes and within MERGE_RTOL_ALL on every lane (a
# lane's sum of photons of other wavelengths may cancel in a channel, and
# the card's and the CPU's exponentials in the CIE fit round apart)
MERGE_RTOL = 1e-5
MERGE_SHARE = 0.999
MERGE_RTOL_ALL = 1e-4
# the caustics VCM path is profiled at this film: the profiler's own cost
# grows with the kernels an iteration launches (about 275,000), and passed
# 30 s at 256x256
CAUSTICS_PROFILE_SIZE = (128, 128)
# the 32x32 card-vs-CPU renders of the VCM slice: (label, builder, options,
# iterations, kernels that must launch). Merging runs with a photon cap
# above every cell's occupancy: with the default cap, an over-full cell
# keeps the photons first in the order of a hash of their positions' bits,
# and positions an ulp apart on the card and the CPU keep other photons
# (tests/test_torch_vcm.py); with a cap of 0 the merge scan stops at 128
# photons a cell, chosen in the same order
_UNCAPPED = vcm.VCMOptions(max_photons_per_cell=1 << 20)
VCM_E2E = (
    ("VCM Cornell 32x32", lambda d: cornell_scene((32, 32), 6, d), _UNCAPPED, 2,
     ("intersect", "occluded")),
    ("light-tracing Cornell 32x32", lambda d: cornell_scene((32, 32), 6, d),
     vcm.light_tracing_options(), 4, ("intersect", "occluded")),
    ("caustics VCM spectral 32x32",
     lambda d: caustics.build_caustics_scene((32, 32)).build(device=d),
     _UNCAPPED, 1, ("intersect_brute2", "occluded_brute2")),
    ("volumetric BDPT 32x32", lambda d: volumetric.volumetric((32, 32)).build(device=d),
     vcm.bdpt_options(), 2, ("intersect",)),
    ("env-lit floor VCM 32x32", lambda d: atmosphere.env_floor_scene((32, 32)).build(device=d),
     _UNCAPPED, 4, ("intersect", "occluded")),
    ("env-lit floor BDPT 32x32", lambda d: atmosphere.env_floor_scene((32, 32)).build(device=d),
     vcm.bdpt_options(), 4, ("intersect", "occluded")))
# bench config 3 (the atmosphere: sun, sky, thin lens, spectral) at the
# bench's film by `bench.py:_pt_mrays`'s protocol: ATMOSPHERE_ITERATIONS
# warm iterations, then ATMOSPHERE_REPS timed repetitions of as many
ATMOSPHERE_SIZE = (512, 512)
ATMOSPHERE_ITERATIONS = 8
ATMOSPHERE_REPS = 1
# its mean luminance after the last repetition must lie in this range: the
# port's CPU render at 128x128, 8 spp, 0.2546339 (the JAX package's
# 0.2546315; at 64x64 both 0.2533538, so the mean has settled; `python -m
# tests.atmosphere_reference_means`), +-10%
ATMOSPHERE_MEAN = (0.22917, 0.28010)
# the 32x32 card-vs-CPU path-traced renders of the image slice besides the
# atmosphere's: (label, builder, spp)
IMAGE_E2E = (
    ("DOF Cornell with a lens image", lambda d: cornell.build_dof_cornell_box(
        (32, 32), diffuse_only=True, max_path_length=6).build(device=d), 4),)
# the 32x32 card-vs-CPU renders of the media slice: (label, builder, spp)
MEDIA_E2E = (
    ("volumetric", lambda: volumetric.volumetric((32, 32)), 4),
    ("random-walk SSS", lambda: volumetric.subsurface_cornell(
        (32, 32), scene_types.SubsurfaceClass.RandomWalk), 2),
    ("Christensen-Burley SSS", lambda: volumetric.subsurface_cornell(
        (32, 32), scene_types.SubsurfaceClass.ChristensenBurley), 2),
    ("fog + Boundary cube + radiance clamp", lambda: volumetric.fog_boundary_cornell((32, 32)),
     4))
# the all-classes shading showcase (`tests/shading_showcase.py`, 2,916
# triangles, spectral, path length 16, blue noise) at 512x512 by
# `bench.py:_pt_mrays`'s protocol shortened: SHOWCASE_ITERATIONS warm
# iterations, then SHOWCASE_REPS timed repetitions of as many
SHOWCASE_SIZE = (512, 512)
SHOWCASE_ITERATIONS = 1
SHOWCASE_REPS = 1
SHOWCASE_CLASSES = (0, 1, 2, 3, 6, 8, 9, 10)
SHOWCASE_TRIANGLES = 36 + 9 * 320
# its mean luminance after the last repetition must lie in this range: the
# port's CPU render at 64x64, 4 spp, SHOWCASE_REFERENCE (`python -m
# tests.shading_reference_means`, which prints the JAX package's beside
# it), +-10%
SHOWCASE_REFERENCE = 0.0704459
SHOWCASE_MEAN = (0.06340, 0.07749)
# the showcase's 32x32 VCM render card vs CPU: merging without the per-cell
# cap, at a merge radius that keeps every cell within the 32 photons the
# glossy merge examines (with a diffuse variation present, Diffuse lanes
# merge through the BSDF dispatch, and an over-full cell would give it its
# first 32 photons in the order of a hash of their positions' last bits)
SHOWCASE_VCM = vcm.VCMOptions(max_photons_per_cell=1 << 20, initial_radius=0.02)
# the CLI phase: the Cornell scene files (`scene/assets.py`: the Cornell box
# with the silver tall box, 36 triangles) at their own 640x640, 32 spp and
# path length 1023, through `python -m etx_tracer_tpu_torch.cli render`
# at CLI_PT_SPP spp; then `--adaptive --spp CLI_ADAPTIVE_SPP` (32 warm spp
# by the scatter pool, then batches of 8 over the active-pixel map) and two
# debug AOVs through `cli.main`.
# Each image's mean must lie within +-10% of the port's CPU render of the
# same command at 64x64 (`python -m tests.cli_reference_means`, which
# prints the JAX package's beside it): pt 0.0736629, adaptive 0.0740793,
# normals 0.5495412, albedo 0.7155893
CLI_SPP, CLI_PT_SPP, CLI_ADAPTIVE_SPP = 32, 16, 48   # the file's, and cut to fit
CLI_PT_MEAN = (0.06630, 0.08103)
CLI_ADAPTIVE_MEAN = (0.06667, 0.08149)
CLI_DEBUG_MEANS = {"normals": (0.49459, 0.60450), "albedo": (0.64403, 0.78715)}
# the adaptive map and one mapped batch, card against CPU, on the CPU's
# 32 warm spp of the scene files at this size and path length (the files'
# 1023 takes a minute of the host's CPU at 32x32)
CLI_MAP_SIZE = (32, 32)
CLI_MAP_PATH_LENGTH = 8
CLI_MAP_THRESHOLD = 0.5

# the sharding slice: the main path's Cornell (512x512, path length 1023) at
# 8 spp on 3 gloo ranks that share the card (512 rows pad to 513) and on a
# NCCL world of 1; bench config 5 by VCM on 2 gloo ranks; --devices; the
# viewer; the validating build
SHARDED_SPP = 8
SHARDED_GLOO_RANKS = 3
SHARDED_VCM_RANKS = 2
SHARDED_VCM_SMALL = (32, 32)
SHARDED_VCM_ITERATIONS = 2
SPAWN_TIMEOUT = 600.0
DEVICES_SPP = 8
# the viewer's scene (`cli view cornell`: the conductor tall box, path
# length 8) at 512x512: +-10% of the port's 64x64 16-spp CPU mean 0.068885
# (`python -m tests.viewer_reference_means`)
VIEWER_SIZE = (512, 512)
VIEWER_MEAN = (0.06200, 0.07577)
VIEWER_ITERATIONS = 3
VIEWER_TIMEOUT = 240.0
VALIDATE_SIZE = (64, 64)
VALIDATE_SPP = 4
# the walks' slice: the shading showcase under MS_BACKEND = "walk" at its
# full size, one warm and one timed iteration, gated by +-10% of the port's
# 64x64 4-spp walked CPU render's mean luminance (`python -m
# tests.shading_reference_means 64 both walk`: port 0.0704431, JAX
# 0.0704544); profiled at WALK_PROFILE_SIZE
WALK_ITERATIONS = 1
WALK_SHOWCASE_REFERENCE = 0.0704431
WALK_SHOWCASE_MEAN = (0.06340, 0.07749)
WALK_PROFILE_SIZE = (128, 128)
# the NanoVDB cloud through `cli render`: bench config 4's 24^3 density as a
# BLOSC .nvdb in the Cornell scene files' medium
NVDB_SIZE = (384, 384)
NVDB_SPP = 8
NVDB_PATH_LENGTH = 10   # bench config 4's
# denoise_eval's protocol with its ground truth cut to fit the time limit
DENOISE_GT_SPP = 1024


def _shading_showcase():
  """`tests/shading_showcase.py`, loaded by its path (a `tests` package
  installed elsewhere would shadow the repository's directory)."""
  path = Path(__file__).resolve().parent / "tests" / "shading_showcase.py"
  spec = importlib.util.spec_from_file_location("shading_showcase", path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def showcase_scene(film, dev, max_path_length=16):
  """The all-classes showcase, staged and frozen on `dev`, with blue noise."""
  scene, config = staged("shading showcase", _shading_showcase().showcase(
      cornell, scene_builder, scene_types, spectrum, spectral_data, film_size=film,
      max_path_length=max_path_length), dev)
  return scene, dataclasses.replace(config, blue_noise=True)


# the 32x32 card-vs-CPU renders of the shading slice: (label, builder,
# options (None: path tracing), spp or iterations, kernels that must launch);
# the showcase's VCM render is cut to path length 4 (at 16 its iteration
# takes minutes on the CPU: every lane runs every lobe, the VCM passes' at
# each stored vertex and merged photon; at 16x16 one outlier pixel moves
# the mean by 0.42%, near the 0.5% bound)
SHADING_E2E = (
    ("shading showcase spectral blue noise 32x32", lambda d: showcase_scene((32, 32), d), None, 1,
     ("intersect_brute2", "occluded_brute2")),
    ("shading showcase VCM mpl 4 32x32",
     lambda d: showcase_scene((32, 32), d, max_path_length=4),
     SHOWCASE_VCM, 1, ("intersect_brute2", "occluded_brute2")),
    ("specular-box Cornell 32x32", lambda d: cornell.build_cornell_box(
        (32, 32), max_path_length=8, specular_boxes=True).build(device=d), None, 4,
     ("intersect", "occluded")))
T0 = time.perf_counter()


def say(phase: str, msg: str):
  print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {msg}", flush=True)


def check(cond: bool, what: str):
  if not cond:
    raise AssertionError(what)


# ------------------------------------------------------------------- timing


def event_ms(fn, reps: int) -> float:
  """Mean milliseconds per call, by CUDA events around `reps` calls."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / reps


def kernel_ms(fn, kernel_name: str, reps: int) -> float:
  """Device time per call of the kernels whose names contain `kernel_name`,
  from the profiler's trace of `reps` calls: each such kernel's mean time per
  launch, summed (K6 launches two a call, its pack and walk kernels). A mean
  per launch, not a total over the calls: the profiler may drop some of a
  trace's kernel records (and a trace with none is taken again, up to three
  times; after three such traces the time is taken by CUDA events around
  the calls, launches and the gaps between them included, and a line says
  so)."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  for _ in range(3):  # a trace that lost every record is taken again
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    per_launch = [ev.device_time_total / ev.count for ev in prof.key_averages()
                  if kernel_name in ev.key and ev.count > 0 and ev.device_time_total > 0.0]
    if per_launch:
      return sum(per_launch) / 1e3
  ms = event_ms(fn, reps)
  say("timing", f"the profiler recorded no {kernel_name} launch in three traces: "
      f"{ms:.4f} ms a call by CUDA events")
  return ms


def bound_ms(ops: int, nbytes: int):
  """Least time the card could take: the larger of the operations over the
  FP32 peak and the bytes over the HBM peak. Returns (ms, bound_by)."""
  t_ops = ops / PEAK_FP32_FLOPS
  t_bytes = nbytes / PEAK_HBM_BYTES
  return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------------- inputs


def tri_soup(rng, n: int, dev):
  v0 = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
  e1 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
  e2 = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
  return [torch.from_numpy(a).to(dev) for a in (v0, e1, e2)]


def soup_tree(rng, n: int, dev):
  """(triangle arrays, BVH) of a random n-triangle soup, the tree built as
  a scene's is."""
  tris = tri_soup(rng, n, dev)
  v0, e1, e2 = (x.cpu().numpy() for x in tris)
  tree = bvh_build.build_bvh(v0, e1, e2)
  arrays = {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
            **{f"bvh.{k}": v for k, v in tree.items()}}
  return tris, scene_types.bvh_from_arrays(bvh_build.kernel_tables(arrays), dev)


def comb_arrays(rng, depth: int) -> dict:
  """The numpy arrays (triangles "tri_v0", ..., and the tree "bvh.node_min",
  ..., "bvh.fat_rows", in `bvh_build.build_bvh`'s layout) of a comb of
  `depth` levels: spine node k has spine node k + 1 as its left child and,
  as its right child, an inner node over two one-triangle leaves; the last
  spine node has two leaves. Every box is the scene's, so a ray from inside
  walks every row, and its fat walk pushes depth - 1 entries: a stack
  deeper than any scene's so far (depth 61 pushes 60 of the kernels' 64)."""
  num_t = 2 * depth
  v0 = rng.uniform(-1.0, 1.0, (num_t, 3)).astype(np.float32)
  e1 = rng.uniform(-0.5, 0.5, (num_t, 3)).astype(np.float32)
  e2 = rng.uniform(-0.5, 0.5, (num_t, 3)).astype(np.float32)
  corners = np.stack([v0, v0 + e1, v0 + e2])
  lo, hi = corners.min(axis=(0, 1)), corners.max(axis=(0, 1))
  left, count = [], []

  def node(n_tris, first=0):
    left.append(first)
    count.append(n_tris)
    return len(left) - 1

  def leaf():
    return node(1, sum(count))

  def two_leaves(i):
    leaf()
    left[i] = leaf()

  for _ in range(depth - 1):   # pre-order: the spine first, then the pairs
    node(0)
  spine = list(range(depth - 1))
  last = node(0)
  two_leaves(last)
  for k in reversed(spine):
    left[k] = node(0)
    two_leaves(left[k])
  tree = {"node_min": np.tile(lo, (len(left), 1)), "node_max": np.tile(hi, (len(left), 1)),
          "node_left": np.asarray(left, np.int32), "node_count": np.asarray(count, np.int32),
          "prim_index": np.arange(num_t, dtype=np.int32)}
  tree["fat_rows"] = bvh_build.build_fat_rows(tree["node_min"], tree["node_max"],
                                             tree["node_left"], tree["node_count"])
  return {"tri_v0": v0, "tri_e1": e1, "tri_e2": e2,
          **{f"bvh.{k}": v for k, v in tree.items()}}


def comb_tree(rng, depth: int, dev):
  """(triangle arrays, BVH) of the comb of `comb_arrays`."""
  arrays = comb_arrays(rng, depth)
  tris = [torch.from_numpy(arrays[k]).to(dev) for k in ("tri_v0", "tri_e1", "tri_e2")]
  return tris, scene_types.bvh_from_arrays(bvh_build.kernel_tables(arrays), dev)


def test_rays(rng, v0, e1, e2, n: int, dev, inside=None):
  """n rays: random ones, axis-parallel ones, ones aimed at shared triangle
  edges and vertices, and ones with t_max = -1 (padded or dead lanes).
  Origins lie in the triangles' bounding box grown by 0.5, or in the box
  `inside` = (lo, hi) when given."""
  v0, e1, e2 = (x.cpu().numpy() for x in (v0, e1, e2))
  lo, hi = inside if inside is not None else (v0.min(0) - 0.5, v0.max(0) + 0.5)
  o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
  d = rng.normal(size=(n, 3)).astype(np.float32)
  q = n // 8
  # axis-parallel directions
  axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
  d[:q] = axes[rng.integers(0, 6, q)]
  # aimed at points on the edge v0 -> v0 + e2 of a triangle, which a quad
  # or a sphere shares with its neighbour, and at vertices
  ti = rng.integers(0, v0.shape[0], q)
  s = rng.uniform(0.0, 1.0, (q, 1)).astype(np.float32)
  s[: q // 4] = 0.0  # vertices
  target = v0[ti] + s * e2[ti]
  d[q:2 * q] = target - o[q:2 * q]
  d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
  t_min = np.full(n, 1e-4, np.float32)
  t_max = np.full(n, 1e30, np.float32)
  t_max[2 * q:2 * q + q // 4] = -1.0
  t_max[2 * q + q // 4:2 * q + q // 2] = rng.uniform(0.0, 3.0, q // 4)
  return [torch.from_numpy(a).to(dev) for a in (o, d, t_min, t_max)]


ROOM = ((-0.95, 0.05, -0.95), (0.95, 1.95, 0.95))  # inside the Cornell room


def staged(label, builder, dev):
  """`builder` frozen on `dev`, saying which BVH builder staged it (the
  native library's, or numpy's where the library does not build)."""
  out = builder.build(device=dev)
  say("stage", f"{label} {builder.film_size[0]}x{builder.film_size[1]}: "
      f"{out[0].tri_v0.shape[0]} triangles, BVH built by {builder.bvh_builder}")
  return out


def cornell_scene(film, mpl, dev):
  return staged("cornell", cornell.build_cornell_box(film_size=film, diffuse_only=True,
                                                     max_path_length=mpl), dev)


def materials_scene(film, dev):
  return staged("materials", materials.build_materials_scene(film), dev)


def bigscene_scene(film, dev, fat_rows=True):
  """Bigscene on `dev`; without fat rows the trace dispatch takes K7/K8."""
  scene, config = staged("bigscene", bigscene.build_bigscene(film), dev)
  if not fat_rows:
    scene = scene._replace(bvh=scene_types.without_fat_rows(scene.bvh))
  return scene, config


def first_hit_pairs(v0, e1, e2, o, d, t_min, t_max, live, mask=None) -> int:
  """Ray-triangle pairs an any-hit loop over the triangles in index order
  that stops at the first hit needs, for the rays `live` (K2's)."""
  first = torch.full_like(t_max, float(v0.shape[0]))
  for ti in reversed(range(v0.shape[0])):
    if mask is not None and not bool(mask[ti]):
      continue
    one = brute_trace.occluded_plain(v0[ti:ti + 1], e1[ti:ti + 1], e2[ti:ti + 1],
                                     o, d, t_min, t_max)
    first = torch.where(one, float(ti + 1), first)
  return int(torch.where(live, first, 0.0).sum().item())


def first_hit_pairs_chunked(mod, v0, e1, e2, o, d, t_min, t_max) -> int:
  """Ray-triangle pairs K4's or K9b's any-hit loop tests: up to each ray's
  first valid pair, by the kernel's own validity test (`mod._pairs`), one
  512-triangle chunk at a time, for the rays that its skip test
  (`mod.dead_lanes`) does not find dead."""
  if mod is woop_trace:
    tab = woop_trace.woop_tables(v0, e1, e2)
    valid = lambda c, ray: woop_trace._pairs(tab[c], ray)[0]
  else:
    valid = lambda c, ray: brute2_trace._pairs(v0[c], e1[c], e2[c], ray)[0]
  num_t = v0.shape[0]
  total = 0
  for sl, ray in mod._ray_tiles(o, d, t_min, t_max):
    first = torch.full((ray[0].shape[0],), num_t, dtype=torch.int64, device=o.device)
    for s in range(0, num_t, mod.CHUNK):
      ok = valid(slice(s, s + mod.CHUNK), ray)
      width = ok.shape[1]
      rev = torch.arange(width, 0, -1, device=o.device)   # width - j: the first wins
      at = s + width - (ok * rev).amax(dim=1)             # first valid index
      first = torch.minimum(first, torch.where(ok.any(dim=1), at + 1, num_t))
    total += int(torch.where(mod.dead_lanes(t_min[sl], t_max[sl]), 0, first).sum().item())
  return total


# ------------------------------------------------------------------- phases

KERNELS = {
    # name: (wrapper module, entry, profiler kernel name, replaces, source)
    "intersect": (brute_trace, "intersect", "brute_intersect_kernel",
                  "etx_tracer_tpu/ops/pallas_trace.py:111",
                  "etx_tracer_tpu_torch/csrc/brute_trace.cu"),
    "occluded": (brute_trace, "occluded", "brute_intersect_kernel",
                 "etx_tracer_tpu/ops/pallas_trace.py:903",
                 "etx_tracer_tpu_torch/csrc/brute_trace.cu"),
    "intersect_brute2": (brute2_trace, "intersect", "brute2_kernel",
                         "etx_tracer_tpu/ops/pallas_trace.py:1121",
                         "etx_tracer_tpu_torch/csrc/brute2_trace.cu"),
    "occluded_brute2": (brute2_trace, "occluded", "brute2_kernel",
                        "etx_tracer_tpu/ops/pallas_trace.py:1148",
                        "etx_tracer_tpu_torch/csrc/brute2_trace.cu"),
    "intersect_bvh_fat": (bvh_trace, "intersect_fat", "bvh_fat_kernel",
                          "etx_tracer_tpu/ops/pallas_trace.py:781",
                          "etx_tracer_tpu_torch/csrc/bvh_trace.cu"),
    "occluded_bvh_fat": (bvh_trace, "occluded_fat", "bvh_fat_kernel",
                         "etx_tracer_tpu/ops/pallas_trace.py:818",
                         "etx_tracer_tpu_torch/csrc/bvh_trace.cu"),
    "intersect_bvh": (bvh_trace, "intersect_node", "bvh_node_kernel",
                      "etx_tracer_tpu/ops/pallas_trace.py:482",
                      "etx_tracer_tpu_torch/csrc/bvh_trace.cu"),
    "occluded_bvh": (bvh_trace, "occluded_node", "bvh_node_kernel",
                     "etx_tracer_tpu/ops/pallas_trace.py:524",
                     "etx_tracer_tpu_torch/csrc/bvh_trace.cu"),
    "intersect_woop": (woop_trace, "intersect", "woop_kernel",
                       "etx_tracer_tpu/ops/pallas_trace.py:1365",
                       "etx_tracer_tpu_torch/csrc/woop_trace.cu"),
    "occluded_woop": (woop_trace, "occluded", "woop_kernel",
                      "etx_tracer_tpu/ops/pallas_trace.py:1392",
                      "etx_tracer_tpu_torch/csrc/woop_trace.cu"),
}
CLOSEST = ("intersect", "intersect_brute2", "intersect_bvh_fat", "intersect_bvh",
           "intersect_woop")


def reset_counts():
  for mod in (brute_trace, brute2_trace, bvh_trace, woop_trace):
    for key in mod.launches:
      mod.launches[key] = 0


def read_counts():
  return {name: mod.launches[entry] for name, (mod, entry, *_) in KERNELS.items()}


def kernel_call(name, geometry, plain=False):
  """The kernel's wrapper (or its plain version) bound to its geometry: the
  triangle arrays for K1-K4, the BVH for K5-K8."""
  mod, entry = KERNELS[name][:2]
  fn = getattr(mod, f"{entry}_plain" if plain else entry)
  tris, bvh = geometry
  head = [bvh] if mod is bvh_trace else list(tris)
  return lambda *rays, tri_mask=None: fn(*head, *rays, tri_mask=tri_mask)


def compare_intersect(name, geometry, rays, mask, ref=None):
  hit = kernel_call(name, geometry)(*rays, tri_mask=mask)
  if ref is None:
    ref = kernel_call(name, geometry, plain=True)(*rays, tri_mask=mask)
  torch.cuda.synchronize()
  check(torch.equal(hit.tri, ref.tri), f"{name}: tri differs from the plain version")
  found = ref.tri >= 0
  check(torch.equal(torch.isinf(hit.t), torch.isinf(ref.t)), f"{name}: misses differ")
  err = 0.0
  for a, b in ((hit.t, ref.t), (hit.u, ref.u), (hit.v, ref.v)):
    diff = torch.where(found, (a - b).abs(), 0.0)
    check(bool((diff <= KERNEL_ATOL * torch.clamp(b.abs(), min=1.0)).all()),
          f"{name}: t/u/v differ from the plain version by up to {diff.max().item()}")
    err = max(err, diff.max().item())
  return err, float(found.float().mean().item())


def compare_occluded(name, geometry, rays, mask, ref=None):
  occ = kernel_call(name, geometry)(*rays, tri_mask=mask)
  if ref is None:
    ref = kernel_call(name, geometry, plain=True)(*rays, tri_mask=mask)
  torch.cuda.synchronize()
  check(torch.equal(occ, ref), f"{name}: occlusion differs from the plain version")
  return float(occ.float().mean().item())


def work(name, geometry, rays):
  """(operations, bytes, what was counted) of one call, for its bound: the
  FP32 operations the kernel's loop needs for these rays, and each ray byte
  read once, each output byte written once and the tables read once."""
  mod, entry = KERNELS[name][:2]
  tris, bvh = geometry
  num_r = rays[0].shape[0]
  out_bytes = 16 if entry.startswith("intersect") else 1
  if mod is bvh_trace:
    fat = entry.endswith("fat")
    zeros = lambda: torch.zeros(num_r, dtype=torch.int64, device=rays[0].device)
    stats = {"boxes": 0, "tris": 0, "ray_rows": zeros(), "ray_tris": zeros()}
    getattr(bvh_trace, f"{entry}_plain")(bvh, *rays, stats=stats)
    # a ray with an empty interval needs no test (K5-K8 skip it); the rest
    # need the walk's box and triangle tests
    live = live_lanes(name, rays)
    rows = int(stats["ray_rows"][live].sum().item())
    tri_tests = int(stats["ray_tris"][live].sum().item())
    ops = rows * (2 if fat else 1) * FLOPS_PER_BOX + tri_tests * FLOPS_PER_BVH_TRI
    # the words the walk reads: a fat row but its skip word, a whole node
    # row, a triangle row but its 2 pad words; every ray's interval is read
    # and its output written, a live ray's origin and direction read
    table_bytes = bvh.fat_table.shape[0] * 60 if fat else bvh.node_table.shape[0] * 32
    n_live = int(live.sum().item())
    nbytes = (num_r * (8 + out_bytes) + n_live * 24 + table_bytes
              + bvh.prim_tris.shape[0] * 40)
    counted = {"rows" if fat else "nodes": rows, "tris": tri_tests, "live rays": n_live}
    return ops, nbytes, counted, walk_line(stats["ray_rows"], stats["ray_tris"], fat)
  live_mask = live_lanes(name, rays)
  live = int(live_mask.sum().item())
  t_tri = tris[0].shape[0]
  if entry == "intersect":
    pairs = live * t_tri
  elif mod is brute_trace:
    pairs = first_hit_pairs(*tris, *rays, live_mask)
  else:
    pairs = first_hit_pairs_chunked(mod, *tris, *rays)
  nbytes = num_r * (32 + out_bytes) + t_tri * TRI_BYTES[mod]
  return pairs * FLOPS_PER_PAIR[mod], nbytes, {"pairs": pairs, "live rays": live}, None


def walk_line(ray_rows, ray_tris, fat: bool) -> str:
  """Per-ray work of the plain walk, over every ray in index order (dead
  lanes included, as a kernel with one ray a thread walks them): mean, p99
  and max rows (nodes) and triangle tests a ray, and the share of lane
  slots that carry a step when each thread walks one ray and a warp of 32
  consecutive rays runs until its longest walk ends."""
  parts = []
  for what, x in (("fat rows" if fat else "nodes", ray_rows), ("triangle tests", ray_tris)):
    xf = x.double()
    pad = (-x.shape[0]) % 32
    warps = torch.cat([xf, xf.new_zeros(pad)]).view(-1, 32)
    share = float(xf.sum() / (32.0 * warps.amax(dim=1)).sum().clamp(min=1.0))
    parts.append(f"{what} a ray mean {float(xf.mean()):.2f} p99 {float(xf.quantile(0.99)):.0f} "
                 f"max {int(x.max())}, useful lane share {share:.3f}")
  return "; ".join(parts)


def live_lanes(name, rays):
  """(R,) bool: the rays that need work of kernel `name`, those that its
  module's skip test (`dead_lanes`) does not find dead: a dead ray has no
  valid pair (the proofs are in the kernels' sources), so it needs no test."""
  return ~KERNELS[name][0].dead_lanes(rays[2], rays[3])


def lane_variants(rays, n: int = FEW_RAYS):
  """The first n of `rays` under each lane pattern the pair-tile and BVH
  kernels must take: dead lanes (t_max = 0 or -0, which K3/K4 skip; a NaN
  t_min or a t_min one ulp above t_max, which K5-K8 skip) among live ones,
  intervals that are not empty, strided rays."""
  o, d, t_min, t_max = (x[:n] for x in rays)
  every_other = t_max.clone()
  every_other[::2] = 0.0
  one_per_warp = torch.full_like(t_max, -0.0)
  one_per_warp[::32] = t_max[::32]
  zeros = torch.zeros_like(t_min)
  nan_third = t_min.clone()
  nan_third[1::3] = float("nan")
  ulp_above = t_min.clone()
  ulp_above[::2] = torch.nextafter(t_max[::2], torch.tensor(float("inf"), device=t_max.device))
  wide = torch.cat([o, d], dim=1)
  return {"every other lane dead": (o, d, t_min, every_other),
          "all dead": (o, d, t_min, torch.zeros_like(t_max)),
          "one live ray per warp": (o, d, t_min, one_per_warp),
          "t_max == t_min": (o, d, t_min, t_min.clone()),
          "t_min = t_max = 0": (o, d, zeros, zeros.clone()),
          "NaN t_min on every third lane": (o, d, nan_third, t_max),
          "t_min one ulp above t_max on every other lane": (o, d, ulp_above, t_max),
          "strided": (wide[:, :3], wide[:, 3:], t_min, t_max)}


def compare(name, geometry, rays, mask, ref=None):
  """(max abs error, hit fraction) of the kernel against its plain version
  (`ref`: the plain version's result on these rays, when it was run)."""
  if name in CLOSEST:
    return compare_intersect(name, geometry, rays, mask, ref)
  return 0.0, compare_occluded(name, geometry, rays, mask, ref)


def plain_per_pattern(name, geometry, patterns, mask):
  """The plain version's result on each lane pattern's rays (`patterns`, as
  `lane_variants` gives them), from one call on all of them together: a
  ray's plain result does not depend on the other rays, and a plain BVH
  walk, a Python loop over the walk's steps, takes as long for one ray as
  for a batch whose longest walk is as long."""
  sizes = [rays[0].shape[0] for rays in patterns.values()]
  ref = kernel_call(name, geometry, plain=True)(
      *(torch.cat([rays[k] for rays in patterns.values()]) for k in range(4)), tri_mask=mask)
  parts = [torch.split(x, sizes) for x in ref] if name in CLOSEST else [torch.split(ref, sizes)]
  return {label: (type(ref)(*(p[i] for p in parts)) if name in CLOSEST else parts[0][i])
          for i, label in enumerate(patterns)}


def occupancy_note(name, num_t, num_r):
  """Blocks per SM and waves of a K1-K4 or K9a/K9b launch for this shape, or
  the grid of K5-K8 (persistent for the closest hits)."""
  sms = torch.cuda.get_device_properties(0).multi_processor_count
  if KERNELS[name][0] is brute_trace:
    blocks, tile = brute_trace.launch_shape(num_t, num_r, name not in CLOSEST)
    grid = -(-num_r // tile)
    return (f"{blocks} blocks of 256 threads per SM, {tile} rays a block, {grid} blocks in "
            f"{grid / (blocks * sms):.2f} waves of {blocks * sms}")
  if KERNELS[name][0] is bvh_trace:
    any_hit = name not in CLOSEST
    blocks, threads = bvh_trace.occupancy(KERNELS[name][1].endswith("fat"), any_hit)
    # at most the resident grid, at least one ray a warp
    grid = min(blocks * sms, -(-num_r // (threads // 32)))
    head = f"{blocks} blocks of {threads} threads per SM ({blocks * threads // 32} resident warps)"
    if not any_hit:
      return f"{head}, {grid} persistent blocks for {num_r} rays"
    return (f"{head}, {max(grid, -(-num_r // threads))} blocks for {num_r} rays, one live ray "
            f"a lane, the live rays spread over the warps of {grid} blocks")
  mod = KERNELS[name][0]
  blocks = mod.occupancy(num_t, name not in CLOSEST)
  grid = -(-num_r // mod.TILE_RAYS)
  return (f"{blocks} blocks of {mod.TILE_RAYS} threads per SM, {mod.TILE_RAYS} rays a block, "
          f"{grid} blocks in {grid / (blocks * sms):.2f} waves of {blocks * sms}")


def kernel_phase(name, dev, rng, cases, timed):
  """Hold one kernel against its plain version on every case (with and
  without masked rows, and under each lane pattern of `lane_variants`: K1/K2
  on tables of at most 1,024 triangles, K9a/K9b of at most 4,096), then time
  both on each case of `timed`; the
  first timed case is the one the `kernels` line reports. A case is (label,
  (tris, bvh), origin box or None, rays)."""
  kname = KERNELS[name][2]
  mod = KERNELS[name][0]
  err = 0.0
  for label, geometry, inside, num_r in cases:
    tris = geometry[0]
    rays = test_rays(rng, *tris, num_r, dev, inside)
    masks = (None, torch.from_numpy(rng.uniform(size=tris[0].shape[0]) > 0.25).to(dev))
    lanes = not ((mod is brute_trace and tris[0].shape[0] > BRUTE_LANE_TRIS)
                 or (mod is woop_trace and tris[0].shape[0] > WOOP_LANE_TRIS))
    n_lane = BVH_LANE_RAYS if mod is bvh_trace else FEW_RAYS
    for mask in masks:
      patterns = lane_variants(rays, n_lane) if lanes else {}
      refs = {}
      if mod is bvh_trace:
        # a plain walk takes as long as its longest walk: one call for the
        # rays and all their lane patterns
        refs = plain_per_pattern(name, geometry, {"all": rays, **patterns}, mask)
      e, frac = compare(name, geometry, rays, mask, refs.pop("all", None))
      err = max(err, e)
      say(name, f"{label} tris={tris[0].shape[0]} rays={num_r} masked={mask is not None} "
          f"hit fraction {frac:.4f}: matches the plain version")
      if not lanes:
        continue
      fracs = []
      if not refs:
        refs = plain_per_pattern(name, geometry, patterns, mask)
      for variant, lane_rays in patterns.items():
        e, frac = compare(name, geometry, lane_rays, mask, refs[variant])
        err = max(err, e)
        fracs.append(f"{variant} {frac:.4f}")
      say(name, f"{label} masked={mask is not None} {min(n_lane, num_r)} rays under each lane "
          f"pattern match the plain version; hit fraction " + ", ".join(fracs))

  rows = []
  for label, geometry, inside, num_r in timed:
    rays = test_rays(rng, *geometry[0], num_r, dev, inside)
    run = kernel_call(name, geometry)
    plain = kernel_call(name, geometry, plain=True)
    ops, nbytes, counted, per_ray = work(name, geometry, rays)
    ms = kernel_ms(lambda: run(*rays), kname, 50)
    # one timed call after a warm one: the plain versions take up to seconds
    plain_ms = event_ms(lambda: plain(*rays), 1)
    b_ms, b_by = bound_ms(ops, nbytes)
    say(name, f"{num_r} rays x {geometry[0][0].shape[0]} tris ({label}): kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by} ({ops} FP32 operations "
        f"from {counted}, {nbytes} bytes)")
    if per_ray is not None:
      say(name, f"per-ray work ({label}, plain walk): {per_ray}")
    say(name, occupancy_note(name, geometry[0][0].shape[0], num_r))
    rows.append({"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by})
  return {"max_abs_err": err, **rows[0]}


def narrow_phase(name, geometry, dev, rng, sizes=NARROW, inside=None):
  """K1, K2, K9a or K9b on narrow batches (K1/K2: the cascade's 2^12, 2^14
  and 2^16): test rays with every interval opened (t_max = 1e30 where the
  kernel's skip test found the ray dead), held against the plain version
  and timed, with the launch shape."""
  dead_lanes = KERNELS[name][0].dead_lanes
  for num_r in sizes:
    o, d, t_min, t_max = test_rays(rng, *geometry[0], num_r, dev, inside)
    rays = (o, d, t_min, torch.where(dead_lanes(t_min, t_max), 1e30, t_max))
    e, frac = compare(name, geometry, rays, None)
    run = kernel_call(name, geometry)
    ms = kernel_ms(lambda: run(*rays), KERNELS[name][2], 50)
    ops, nbytes, counted, _ = work(name, geometry, rays)
    b_ms, b_by = bound_ms(ops, nbytes)
    say(name, f"narrow batch of {num_r} live rays x {geometry[0][0].shape[0]} tris (hit "
        f"fraction {frac:.4f}): matches the plain version; kernel {ms:.4f} ms, bound "
        f"{b_ms:.4f} ms by {b_by} ({counted}); "
        + occupancy_note(name, geometry[0][0].shape[0], num_r))


def check_thirds(img, what):
  """Left third red-dominant, right third green-dominant."""
  third = img.shape[1] // 3
  left = img[:, :third].mean(axis=(0, 1))
  right = img[:, -third:].mean(axis=(0, 1))
  check(left[0] > left[1], f"{what}: left third not red-dominant: {left}")
  check(right[1] > right[0], f"{what}: right third not green-dominant: {right}")
  return left, right


def render_main(label, scene, config, iterations, dev):
  """One main-path render with the launch counts set to 0 just before it and
  read just after. Returns (image, counts, seconds, rays)."""
  reset_counts()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  sums, rays = path_tracing.render_samples_static(scene, config, 0, iterations,
                                                  pool_size=1 << 18, device=dev)
  fs = path_tracing.finalize_film(sums, iterations, config.film_width)
  img = film_mod.result_image(fs)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  counts = read_counts()
  rays = int(rays.item())
  say("main", f"{label}: {seconds:.3f} s, {rays} rays, {rays / seconds / 1e6:.3f} Mrays/s, "
      f"launches {counts}")
  img = img.cpu().numpy()
  check(img.shape == (config.film_height, config.film_width, 3), f"image shape {img.shape}")
  check(bool(np.isfinite(img).all()), f"{label}: image has non-finite values")
  return img, counts, seconds, rays


def gate_mean(label, img, bounds):
  """Finite (render_main checked), >= 0, mean inside `bounds`, red left
  third and green right third. Returns the mean."""
  check(bool((img >= 0.0).all()), f"{label}: image has negative values")
  mean = float(img.mean())
  lo, hi = bounds
  check(lo <= mean <= hi, f"{label}: image mean {mean} outside [{lo}, {hi}]")
  left, right = check_thirds(img, label)
  say("main", f"{label} image mean {mean:.5f}, left third RGB {left}, right third RGB {right}")
  return mean


def main_path_cornell(scene, config, dev):
  img, counts, seconds, rays = render_main(
      f"cornell 512x512 mpl 1023 pool 2^18 {ITERATIONS} spp", scene, config, ITERATIONS, dev)
  gate_mean("cornell", img, (0.05, 0.15))
  for key in ("intersect", "occluded"):
    check(counts[key] > 0, f"the Cornell main path never launched the {key} kernel")
  return counts


def main_path_materials(scene, config, dev):
  check(config.spectral and config.material_classes == (0, 3, 4, 5),
        f"materials config {config}")
  img, counts, seconds, rays = render_main(
      f"materials 512x512 spectral mpl 16 pool 2^18 {MATERIALS_ITERATIONS} spp",
      scene, config, MATERIALS_ITERATIONS, dev)
  # a spectral sample's RGB may leave the gamut, but its luminance Y may not
  # be negative (beyond float rounding)
  y = img @ spectrum.RGB_TO_XYZ[1].astype(np.float64)
  check(float(y.min()) >= -1e-5 * max(1.0, float(img.max())),
        f"materials: negative luminance {y.min()}")
  mean = float(img.mean())
  lo, hi = MATERIALS_MEAN
  check(lo <= mean <= hi, f"materials: image mean {mean} outside [{lo}, {hi}]")
  left, right = check_thirds(img, "materials")
  for key in ("intersect_brute2", "occluded_brute2"):
    check(counts[key] > 0, f"the materials main path never launched the {key} kernel")
  say("main", f"materials image mean {mean:.5f}, negative-channel pixels "
      f"{float((img < 0.0).any(axis=-1).mean()):.4f}, left third RGB {left}, "
      f"right third RGB {right}")
  return counts


def main_path_bigscene(scene, config, dev):
  """The bigscene render, through K5/K6, or through K7/K8 (and never K5/K6)
  when the tree has no fat rows. Returns (launch counts, image)."""
  check(not config.spectral and config.material_classes == (0,)
        and scene.tri_v0.shape[0] == bigscene.NUM_TRIANGLES, f"bigscene config {config}")
  fat = scene.bvh.fat_table is not None
  label = "bigscene" if fat else "bigscene without fat rows"
  img, counts, seconds, rays = render_main(
      f"{label} 512x512 mpl 8 pool 2^18 {BIGSCENE_ITERATIONS} spp", scene, config,
      BIGSCENE_ITERATIONS, dev)
  gate_mean(label, img, BIGSCENE_MEAN)
  used, unused = (("intersect_bvh_fat", "occluded_bvh_fat"), ("intersect_bvh", "occluded_bvh"))
  if not fat:
    used, unused = unused, used
  for key in used:
    check(counts[key] > 0, f"the {label} main path never launched the {key} kernel")
  for key in unused:
    check(counts[key] == 0, f"the {label} main path launched the {key} kernel")
  return counts, img


def capture_bounce(scene, config, dev, bounce: int):
  """The closest-hit and the shadow rays that the main path traces at
  `bounce` (0 = the camera rays) of one iteration, as the trace dispatch
  receives them: ((o, d, t_min, t_max), (o, d, t_min, t_max))."""
  from etx_tracer_tpu_torch.ops import trace as trace_ops
  calls = {"closest": 0, "occluded": 0}
  got = {}
  orig = {kind: getattr(trace_ops, f"trace_{kind}") for kind in calls}

  def hook(kind):
    def trace(sc, o, d, t_min, t_max, tri_mask=None):
      check(tri_mask is None, "the main path passed a triangle mask")
      if calls[kind] == bounce:
        got[kind] = tuple(x.clone() for x in (o, d, t_min, t_max))
      calls[kind] += 1
      return orig[kind](sc, o, d, t_min, t_max)
    return trace

  try:
    for kind in calls:
      setattr(trace_ops, f"trace_{kind}", hook(kind))
    path_tracing.render_samples_static(scene, config, 0, 1, pool_size=1 << 18, device=dev)
  finally:
    for kind, fn in orig.items():
      setattr(trace_ops, f"trace_{kind}", fn)
  check(set(got) == set(calls), f"the main path traced fewer than {bounce + 1} bounces")
  return got["closest"], got["occluded"]


def captured_phase(label, names, scene, config, dev):
  """The closest-hit and the any-hit kernel `names` on the rays that a main
  path traces at bounce 2: held against their plain versions, timed, with
  their live share and bound (and, for K5-K8, the plain walk's work a
  ray)."""
  closest, shadow = capture_bounce(scene, config, dev, CAPTURE_BOUNCE)
  geometry = (list(scene[:3]), scene.bvh if KERNELS[names[0]][0] is bvh_trace else None)
  for name, rays in zip(names, (closest, shadow)):
    e, frac = compare(name, geometry, rays, None)
    run = kernel_call(name, geometry)
    ms = kernel_ms(lambda: run(*rays), KERNELS[name][2], 50)
    ops, nbytes, counted, per_ray = work(name, geometry, rays)
    b_ms, b_by = bound_ms(ops, nbytes)
    live = live_lanes(name, rays)
    dead_zero = float((~live & (rays[3] == 0.0)).float().mean().item())
    say("captured", f"{name} on the {label} main path's bounce {CAPTURE_BOUNCE} "
        f"({rays[0].shape[0]} lanes, live share {float(live.float().mean().item()):.4f}, dead "
        f"with t_max = 0 {dead_zero:.4f}, hit fraction {frac:.4f}): matches the plain version "
        f"(max abs err {e}); kernel {ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({ops} FP32 "
        f"operations from {counted}, {nbytes} bytes)")
    if per_ray is not None:
      say("captured", f"{name} per-ray work (plain walk): {per_ray}")
      say("captured", f"{name}: " + occupancy_note(name, geometry[0][0].shape[0],
                                                   rays[0].shape[0]))


class Counting:
  """Counts, while it is entered, the calls of the bounce functions `steps`
  ((module, name) pairs; default `path_tracing.pt_step`) and of
  `torch.Tensor.item` and `torch.Tensor.tolist` (host reads)."""

  def __init__(self, steps=((path_tracing, "pt_step"),)):
    self.steps = steps

  def __enter__(self):
    self.bounces = self.host_reads = 0
    self._saved = [(mod, name, getattr(mod, name)) for mod, name in self.steps]
    self._item, self._tolist = torch.Tensor.item, torch.Tensor.tolist

    def counted(fn):
      def step(*args, **kwargs):
        self.bounces += 1
        return fn(*args, **kwargs)
      return step

    def read(fn):
      def host(t):
        self.host_reads += 1
        return fn(t)
      return host

    for mod, name, fn in self._saved:
      setattr(mod, name, counted(fn))
    torch.Tensor.item, torch.Tensor.tolist = read(self._item), read(self._tolist)
    return self

  def __exit__(self, *exc):
    for mod, name, fn in self._saved:
      setattr(mod, name, fn)
    torch.Tensor.item, torch.Tensor.tolist = self._item, self._tolist


def device_summary(prof):
  """(device busy us, kernels launched, [(us, launches, name)] by time) of a
  finished profile, from its raw kernel records (`key_averages` builds an
  event object for each record: about a minute for a materials or VCM
  iteration's hundreds of thousands of launches)."""
  per_name = {}
  for ev in prof.profiler.kineto_results.events():
    if ev.device_type() == torch.autograd.DeviceType.CUDA:
      t, n = per_name.get(ev.name(), (0.0, 0))
      per_name[ev.name()] = (t + ev.duration_ns() / 1e3, n + 1)
  by_name = sorted(((t, n, key) for key, (t, n) in per_name.items()), reverse=True)
  busy_us = sum(t for t, _, _ in by_name)
  check(busy_us > 0.0, "the profiler recorded no device time")
  return busy_us, sum(n for _, n, _ in by_name), by_name


def profile_step_mix(label, scene, config, dev):
  """Where a main-path bounce spends its time: one iteration under the
  profiler, its bounces and host reads counted as it runs. Prints bounces,
  kernels launched and host reads per bounce, the device's busy share of
  the wall time and the kernels that take most of the device time."""
  from torch.profiler import ProfilerActivity, profile
  with profile(activities=[ProfilerActivity.CUDA]) as prof, Counting() as counted:
    t0 = time.perf_counter()
    path_tracing.render_samples_static(scene, config, 0, 1, pool_size=1 << 18, device=dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  steps = counted.bounces
  busy_us, launched, by_name = device_summary(prof)
  say("profile", f"{label} 1 spp: {steps} bounces, {wall_ms:.1f} ms wall, device busy "
      f"{busy_us / 1e3:.1f} ms ({busy_us / 1e3 / wall_ms:.3f} of wall), "
      f"{launched / max(steps, 1):.0f} kernels and "
      f"{counted.host_reads / max(steps, 1):.1f} host reads per bounce")
  for t, count, key in by_name[:6]:
    say("profile", f"  {t / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
  names = {entry[2] for entry in KERNELS.values()}
  for t, count, key in by_name:
    if any(n in key for n in names):
      say("profile", f"  trace kernel {key[:60]}: {count} launches, "
          f"{t / 1e3 / count:.4f} ms per launch")


def vcm_main(label, scene, config, options, dev):
  """One VCM-family main path: iteration 0 warms up, iterations 1 to
  VCM_TIMED are timed, each through `render_iteration_stats`, with the
  launch counts set to 0 just before iteration 0 and read after the last.
  Returns (film state, image, counts)."""
  fs = film_mod.allocate(config.film_width, config.film_height, dev)
  reset_counts()
  fs, _ = vcm.render_iteration_stats(scene, config, options, fs, 0, device=dev)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  rays = 0
  for i in range(1, 1 + VCM_TIMED):
    fs, r = vcm.render_iteration_stats(scene, config, options, fs, i, device=dev)
    rays += int(r.item())
  torch.cuda.synchronize()
  seconds = (time.perf_counter() - t0) / VCM_TIMED
  counts = read_counts()
  rays_it = rays / VCM_TIMED
  launched = {k: n for k, n in counts.items() if n}
  say("main", f"{label}: {seconds:.3f} s an iteration, {rays_it:.0f} rays an iteration, "
      f"{rays_it / seconds / 1e6:.3f} Mrays/s (iterations 1-{VCM_TIMED}); launches in "
      f"iterations 0-{VCM_TIMED} {launched}")
  img = film_mod.result_image(fs).cpu().numpy()
  check(img.shape == (config.film_height, config.film_width, 3), f"image shape {img.shape}")
  check(bool(np.isfinite(img).all()), f"{label}: image has non-finite values")
  return fs, img, counts


def main_path_caustics(scene, config, dev):
  """Bench config 5 by full VCM: every trace through K3/K4 (1,060
  triangles). A spectral sample's RGB may leave the gamut, and a merged
  photon's RGB is the product of two such RGBs (the camera side's and the
  stored photon's), so a pixel's luminance may fall below 0 too (the JAX
  package merges the same way): the gate holds the light layer's
  luminance (splats of spectral samples) to >= 0 on every pixel (beyond
  rounding) and the image's mean luminance above 0."""
  check(config.spectral and config.max_path_length == 16
        and scene.tri_v0.shape[0] == caustics.NUM_TRIANGLES, f"caustics config {config}")
  options = vcm.VCMOptions()
  label = f"caustics VCM {VCM_SIZE[0]}x{VCM_SIZE[1]} spectral mpl 16"
  fs, img, counts = vcm_main(label, scene, config, options, dev)
  lum = spectrum.RGB_TO_XYZ[1].astype(np.float64)
  y = img @ lum
  y_light = fs.light.cpu().numpy() @ lum
  check(float(y_light.min()) >= -1e-5 * max(1.0, float(img.max())),
        f"caustics VCM: negative light-layer luminance {y_light.min()}")
  check(float(y.mean()) > 0.0, f"caustics VCM: mean luminance {y.mean()}")
  say("main", f"caustics VCM luminance: mean {float(y.mean()):.5f}, pixels below 0 "
      f"{float((y < 0.0).mean()):.4f} (least {float(y.min()):.4f}), least light-layer pixel "
      f"{float(y_light.min()):.3e}")
  mean = float(img.mean())
  lo, hi = CAUSTICS_VCM_MEAN
  check(lo <= mean <= hi, f"caustics VCM: image mean {mean} outside [{lo}, {hi}]")
  left, right = check_thirds(img, "caustics VCM")
  say("main", f"caustics VCM image mean {mean:.5f}, negative-channel pixels "
      f"{float((img < 0.0).any(axis=-1).mean()):.4f}, left third RGB {left}, right third RGB "
      f"{right}")
  for key in ("intersect_brute2", "occluded_brute2"):
    check(counts[key] > 0, f"the caustics VCM main path never launched the {key} kernel")
  others = {k: n for k, n in counts.items() if n and k not in ("intersect_brute2",
                                                                "occluded_brute2")}
  check(not others, f"the caustics VCM main path launched {others}")
  del fs
  small = caustics.build_caustics_scene(CAUSTICS_PROFILE_SIZE).build(device=dev)
  profile_vcm(f"caustics VCM {CAUSTICS_PROFILE_SIZE[0]}x{CAUSTICS_PROFILE_SIZE[1]} spectral "
              "mpl 16", *small, options, dev)
  return counts


def main_path_volumetric_bdpt(scene, config, dev):
  """Bench config 4 by BDPT: every trace, the transmittance walks of the
  camera connections, NEE and the (R*V)-wide vertex connections included,
  through K1; no shadow ray reaches K2."""
  check(config.has_media and config.max_path_length == 10, f"volumetric config {config}")
  options = vcm.bdpt_options()
  label = f"volumetric BDPT {VCM_SIZE[0]}x{VCM_SIZE[1]} mpl 10"
  _, img, counts = vcm_main(label, scene, config, options, dev)
  gate_mean("volumetric BDPT", img, VOLUMETRIC_BDPT_MEAN)
  check(counts["intersect"] > 0, "the volumetric BDPT main path never launched the intersect "
        "kernel")
  others = {k: n for k, n in counts.items() if n and k != "intersect"}
  check(not others, f"the volumetric BDPT main path launched {others}")
  profile_vcm(label, scene, config, options, dev)
  return counts


def profile_vcm(label, scene, config, options, dev):
  """One more iteration of a VCM-family path under the profiler, its
  bounces (of both passes) and host reads counted as it runs: wall time,
  the device's busy share, kernels a bounce and the kernels that take most
  of the device time."""
  from torch.profiler import ProfilerActivity, profile
  fs = film_mod.allocate(config.film_width, config.film_height, dev)
  t0 = time.perf_counter()
  with (profile(activities=[ProfilerActivity.CUDA]) as prof,
        Counting(((vcm, "_light_step"), (vcm, "_camera_step"))) as counted):
    t1 = time.perf_counter()
    vcm.render_iteration(scene, config, options, fs, VCM_TIMED + 1, device=dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t1) * 1e3
  steps = counted.bounces
  busy_us, launched, by_name = device_summary(prof)
  say("profile", f"{label}, one iteration: {steps} bounces (light and camera), {wall_ms:.1f} ms "
      f"wall, device busy {busy_us / 1e3:.1f} ms ({busy_us / 1e3 / wall_ms:.3f} of wall), "
      f"{launched} kernels ({launched / max(steps, 1):.0f} a bounce), {counted.host_reads} host "
      f"reads ({counted.host_reads / max(steps, 1):.1f} a bounce); profiler and its summary "
      f"{time.perf_counter() - t0:.1f} s")
  for t, count, key in by_name[:6]:
    say("profile", f"  {t / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
  names = {entry[2] for entry in KERNELS.values()}
  for t, count, key in by_name:
    if any(n in key for n in names):
      say("profile", f"  trace kernel {key[:60]}: {count} launches, "
          f"{t / 1e3 / count:.4f} ms per launch")


def to_cpu(x):
  """`x` with every tensor in it (through NamedTuples, tuples, dicts and
  material rows) copied to the CPU."""
  if isinstance(x, torch.Tensor):
    return x.cpu()
  if isinstance(x, packed.MaterialRows):
    return packed.MaterialRows(x._rows.cpu())
  if isinstance(x, dict):
    return {k: to_cpu(v) for k, v in x.items()}
  if isinstance(x, tuple):
    items = [to_cpu(v) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
  return x


def capture_vcm_step(scene, config, options, dev, step: int):
  """What camera step `step` of one VCM-family iteration (iteration 1)
  traces, as the trace dispatch receives them: the rays of its closest-hit
  trace ("closest") and of the first trace of its vertex connections
  ("connect": the (R*V)-wide any-hit batch, or with media the first
  segment of the (R*V)-wide transmittance walk); with merging also the
  arguments and result of the iteration's `build_merge_grid` ("grid") and
  of the step's `merge_gather` ("merge")."""
  from etx_tracer_tpu_torch.ops import trace as trace_ops
  seen = {"step": -1, "connecting": False}
  got = {}
  traces = {kind: getattr(trace_ops, kind) for kind in ("trace_closest", "trace_occluded")}
  wrapped = {name: getattr(vcm, name) for name in ("_camera_step", "_connect_vertices",
                                                   "merge_gather", "build_merge_grid")}

  def hook(kind):
    def trace(sc, o, d, t_min, t_max, tri_mask=None):
      check(tri_mask is None, "the main path passed a triangle mask")
      key = "connect" if seen["connecting"] else "closest"
      if (seen["step"] == step and key not in got
          and (seen["connecting"] or kind == "trace_closest")):
        got[key] = tuple(x.clone() for x in (o, d, t_min, t_max))
      return traces[kind](sc, o, d, t_min, t_max)
    return trace

  def camera_step(*args, **kwargs):
    seen["step"] += 1
    return wrapped["_camera_step"](*args, **kwargs)

  def connect(*args, **kwargs):
    seen["connecting"] = True
    try:
      return wrapped["_connect_vertices"](*args, **kwargs)
    finally:
      seen["connecting"] = False

  def gather(*args, **kwargs):
    out = wrapped["merge_gather"](*args, **kwargs)
    if seen["step"] == step and "merge" not in got:
      got["merge"] = (args, kwargs, out)
    return out

  def build(*args, **kwargs):
    out = wrapped["build_merge_grid"](*args, **kwargs)
    got["grid"] = (args, kwargs, out)
    return out

  hooks = {"_camera_step": camera_step, "_connect_vertices": connect, "merge_gather": gather,
           "build_merge_grid": build}
  try:
    for kind in traces:
      setattr(trace_ops, kind, hook(kind))
    for name, fn in hooks.items():
      setattr(vcm, name, fn)
    fs = film_mod.allocate(config.film_width, config.film_height, dev)
    vcm.render_iteration(scene, config, options, fs, 1, device=dev)
    torch.cuda.synchronize()
  finally:
    for kind, fn in traces.items():
      setattr(trace_ops, kind, fn)
    for name, fn in wrapped.items():
      setattr(vcm, name, fn)
  want = {"closest", "connect"} | ({"grid", "merge"} if options.enable_merging else set())
  check(want <= set(got), f"camera step {step} traced or merged less than {sorted(want)}: "
        f"{sorted(got)}")
  return got


def hold_captured(what, name, geometry, rays):
  """Kernel `name` on rays captured from a main path (`what` says where):
  held bit-equal against its plain version, then timed with its plain
  version, beside its live share and bound. Returns the row for the
  `kernels` note."""
  e, frac = compare(name, geometry, rays, None)
  check(e == 0.0, f"{name} on {what}: t/u/v differ from the plain version by up to {e}")
  run = kernel_call(name, geometry)
  ms = kernel_ms(lambda: run(*rays), KERNELS[name][2], 50)
  plain = kernel_call(name, geometry, plain=True)
  plain_ms = event_ms(lambda: plain(*rays), 1)
  ops, nbytes, counted, _ = work(name, geometry, rays)
  b_ms, b_by = bound_ms(ops, nbytes)
  live = live_lanes(name, rays)
  say("captured", f"{name} on {what} ({rays[0].shape[0]} lanes, live share "
      f"{float(live.float().mean().item()):.4f}, hit fraction {frac:.4f}): bit-equal to the "
      f"plain version; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms by "
      f"{b_by} ({ops} FP32 operations from {counted}, {nbytes} bytes)")
  return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def merge_card_vs_cpu(got):
  """The capped merge grid, built on the card and again on the CPU from the
  same light vertices, bit-equal (the sort and every column but the
  throughput's RGB, which goes through the CIE fit's exponentials in
  spectral mode: within MERGE_RTOL of each photon's largest channel); then
  the captured `merge_gather` run again on the CPU on the CPU's grid and
  held to the card's result (MERGE_RTOL on MERGE_SHARE of the lanes,
  MERGE_RTOL_ALL on all)."""
  args, kwargs, grid = got["grid"]
  cpu = vcm.build_merge_grid(*to_cpu(args), **to_cpu(kwargs))
  cap = grid.cell_cap
  for f in ("sorted_cell", "pos", "nrm", "w_i", "d_vcm", "d_vm", "path_length", "valid",
            "grid_min"):
    check(torch.equal(getattr(grid, f).cpu(), getattr(cpu, f)),
          f"merge grid: {f} differs between the card and the CPU")
  check(torch.equal(grid.rows[:, :11].cpu(), cpu.rows[:, :11])
        and torch.equal(grid.rows[:, 14:].cpu(), cpu.rows[:, 14:]),
        "merge grid: packed rows differ between the card and the CPU")
  check(grid.cell_size == cpu.cell_size and cap == cpu.cell_cap, "merge grid: cell size or cap")
  thr_rel = float(row_rel_diff(grid.rows[:, 11:14].cpu().numpy(), cpu.rows[:, 11:14].numpy()).max())
  check(thr_rel <= MERGE_RTOL, f"merge grid: throughput RGB differs by {thr_rel} of a row")
  cells = grid.sorted_cell.cpu()
  _, occ = torch.unique_consecutive(cells[cells <= vcm._HASH_MASK], return_counts=True)
  dropped = int((cells <= vcm._HASH_MASK).sum()) - int(grid.valid.sum())
  check(cap > 0 and int(occ.max()) > cap and dropped > 0,
        f"merge grid: no cell over the cap of {cap} (largest {int(occ.max())})")
  say("captured", f"merge grid ({cells.shape[0]} slots): card and CPU sort, cells and rows "
      "bit-equal, throughput RGB "
      + ("bit-equal" if thr_rel == 0.0 else
         f"within {thr_rel:.2e} of each photon's largest channel (limit {MERGE_RTOL})")
      + "; "
      f"{int((occ > cap).sum())} of {occ.shape[0]} cells over the cap of {cap} (largest "
      f"{int(occ.max())}), {dropped} photons dropped")

  args, kwargs, merged = got["merge"]
  args = to_cpu(args)
  out = vcm.merge_gather(args[0], cpu, *args[2:], **to_cpu(kwargs)).numpy()
  card = merged.cpu().numpy()
  diff = np.abs(card - out)
  lanes = int((out != 0.0).any(axis=-1).sum())
  check(lanes > 0, "merge_gather: no lane merged a photon")
  rel = row_rel_diff(card, out)
  within = float((rel <= MERGE_RTOL).mean())
  check(within >= MERGE_SHARE and float(rel.max()) <= MERGE_RTOL_ALL,
        f"merge_gather: {within} of the lanes within {MERGE_RTOL} of their largest channel, "
        f"the worst at {float(rel.max())}")
  say("captured", f"merge_gather on camera step {VCM_CAPTURE_STEP} ({out.shape[0]} lanes, "
      f"{lanes} with a merged photon), card against the CPU on the CPU's grid, over each "
      f"lane's largest channel: {within:.5f} of the lanes within {MERGE_RTOL} (p99.9 "
      f"{float(np.quantile(rel, 0.999)):.2e}), the worst {float(rel.max()):.2e} (limit "
      f"{MERGE_RTOL_ALL}); largest abs diff {float(diff.max()):.3e}, largest value "
      f"{float(np.abs(out).max()):.4f}")


def row_rel_diff(a, b):
  """Each row's largest difference of `a` from `b`, over the largest
  |value| of that row of `b` (rows of zeros must be equal): a spectral
  sample's RGB comes out of the XYZ-to-RGB matrix, where a channel near 0
  is the difference of large terms, so a channel's own relative error says
  nothing."""
  scale = np.abs(b).max(axis=-1)
  diff = np.abs(a - b).max(axis=-1)
  check(bool((diff[scale == 0.0] == 0.0).all()), "a zero row differs")
  return diff / np.where(scale > 0.0, scale, 1.0)


def captured_vcm_phase(label, scene, config, options, names, dev):
  """The rays of camera step VCM_CAPTURE_STEP of a VCM-family main path:
  the closest-hit kernel (names[0]) on its closest-hit rays, names[1] on
  the first trace of its (R*V)-wide vertex connections, each held against
  its plain version and timed; with merging also the merge grid and
  `merge_gather`, card against CPU. Returns the rows for the `kernels`
  note."""
  got = capture_vcm_step(scene, config, options, dev, VCM_CAPTURE_STEP)
  lanes = config.film_width * config.film_height
  width = got["closest"][0].shape[0]
  check(width == lanes and got["connect"][0].shape[0] == lanes * options.max_stored_vertices,
        f"{label}: camera step {VCM_CAPTURE_STEP} ran at {width} lanes, not {lanes}")
  geometry = (list(scene[:3]), None)
  rows = {}
  for key, name in zip(("closest", "connect"), names):
    what = (f"the {label} main path's camera step {VCM_CAPTURE_STEP} "
            + ("closest-hit rays" if key == "closest" else
               "vertex connections (first transmittance segment)" if config.has_media else
               "vertex connections"))
    rows[f"{name} {key}"] = hold_captured(what, name, geometry, got[key])
  if options.enable_merging:
    merge_card_vs_cpu(got)
  return rows


def volumetric_scene(film, dev):
  return staged("volumetric", volumetric.volumetric(film), dev)


def subsurface_scene(film, dev):
  return staged("subsurface", volumetric.subsurface_cornell(
      film, scene_types.SubsurfaceClass.RandomWalk), dev)


def main_path_volumetric(scene, config, dev):
  """Bench config 4 through the non-deferred bounce: every trace, the
  transmittance segments included, through K1; no shadow ray reaches K2."""
  check(config.has_media and not config.has_subsurface and config.max_path_length == 10
        and not path_tracing.uses_deferred_nee(config), f"volumetric config {config}")
  img, counts, seconds, rays = render_main(
      f"volumetric {VOLUMETRIC_SIZE[0]}x{VOLUMETRIC_SIZE[1]} mpl 10 pool 2^18 "
      f"{VOLUMETRIC_ITERATIONS} spp", scene, config, VOLUMETRIC_ITERATIONS, dev)
  gate_mean("volumetric", img, VOLUMETRIC_MEAN)
  check(counts["intersect"] > 0, "the volumetric main path never launched the intersect kernel")
  check(counts["occluded"] == 0, "the volumetric main path launched the occluded kernel")
  return counts


def main_path_subsurface(scene, config, dev):
  """test_sss_render's configuration: the random walk's traces through K1,
  the deferred shadow rays through K2. Prints K1's launches a bounce inside
  the walk (`render/subsurface.gather`)."""
  check(config.has_subsurface and not config.has_media
        and path_tracing.uses_deferred_nee(config), f"subsurface config {config}")
  per_bounce = []
  gather = path_tracing.sss_mod.gather

  def counted_gather(*args, **kwargs):
    before = brute_trace.launches["intersect"]
    out = gather(*args, **kwargs)
    per_bounce.append(brute_trace.launches["intersect"] - before)
    return out

  path_tracing.sss_mod.gather = counted_gather
  try:
    img, counts, seconds, rays = render_main(
        f"subsurface {VOLUMETRIC_SIZE[0]}x{VOLUMETRIC_SIZE[1]} mpl 6 pool 2^18 "
        f"{SUBSURFACE_ITERATIONS} spp", scene, config, SUBSURFACE_ITERATIONS, dev)
  finally:
    path_tracing.sss_mod.gather = gather
  gate_mean("subsurface", img, SUBSURFACE_MEAN)
  for key in ("intersect", "occluded"):
    check(counts[key] > 0, f"the subsurface main path never launched the {key} kernel")
  walk = np.asarray(per_bounce, np.float64)
  say("main", f"subsurface: K1 launches inside the walk per bounce mean {walk.mean():.2f}, "
      f"max {int(walk.max())} over {walk.size} bounces ({int(walk.sum())} of "
      f"{counts['intersect']} K1 launches)")
  return counts


def capture_segment(scene, config, dev, bounce: int):
  """The rays of the first closest-hit trace that `_trace_transmittance`
  makes at `bounce` of one main-path iteration, as the dispatch receives
  them."""
  from etx_tracer_tpu_torch.ops import trace as trace_ops
  seen = {"bounce": -1, "inside": False, "rays": None}
  step, walk, closest = (path_tracing.pt_step, path_tracing._trace_transmittance,
                         trace_ops.trace_closest)

  def counted_step(*args, **kwargs):
    seen["bounce"] += 1
    return step(*args, **kwargs)

  def marked_walk(*args, **kwargs):
    seen["inside"] = True
    try:
      return walk(*args, **kwargs)
    finally:
      seen["inside"] = False

  def hook(sc, o, d, t_min, t_max, tri_mask=None):
    if seen["inside"] and seen["bounce"] == bounce and seen["rays"] is None:
      seen["rays"] = tuple(x.clone() for x in (o, d, t_min, t_max))
    return closest(sc, o, d, t_min, t_max, tri_mask)

  path_tracing.pt_step, path_tracing._trace_transmittance = counted_step, marked_walk
  trace_ops.trace_closest = hook
  try:
    path_tracing.render_samples_static(scene, config, 0, 1, pool_size=1 << 18, device=dev)
  finally:
    path_tracing.pt_step, path_tracing._trace_transmittance = step, walk
    trace_ops.trace_closest = closest
  check(seen["rays"] is not None, f"no transmittance segment traced at bounce {bounce}")
  return seen["rays"]


def captured_segment_phase(scene, config, dev):
  """K1 on the first transmittance segment of the volumetric path's bounce
  2: held against its plain version, timed, with its live share and bound.
  Returns the row for the `kernels` line's note."""
  rays = capture_segment(scene, config, dev, CAPTURE_BOUNCE)
  return hold_captured(f"the volumetric main path's bounce {CAPTURE_BOUNCE} transmittance "
                       "segment", "intersect", (list(scene[:3]), None), rays)


def main_path_atmosphere(dev):
  """Bench config 3 through `render_samples_static` by `_pt_mrays`'s
  protocol: staged on the host (the sky and the sun marched in numpy),
  then ATMOSPHERE_ITERATIONS warm iterations and ATMOSPHERE_REPS timed
  repetitions of as many, the launch counts set to 0 before the warm-up
  and read after the last repetition. Every trace goes to K1/K2 (12
  triangles). Gates the image: finite, no negative luminance, mean
  luminance inside ATMOSPHERE_MEAN. Returns ((scene, config), the staged
  builder, counts)."""
  t0 = time.perf_counter()
  builder = atmosphere.atmosphere_scene(ATMOSPHERE_SIZE)
  staged = time.perf_counter() - t0
  scene, config = builder.build(device=dev)
  torch.cuda.synchronize()
  built = time.perf_counter() - t0 - staged
  check(config.spectral and config.material_classes == (0,) and config.emitter_classes == (1, 2)
        and config.num_env_emitters == 2 and config.max_path_length == 8
        and scene.tri_v0.shape[0] == atmosphere.NUM_TRIANGLES
        and path_tracing.uses_deferred_nee(config), f"atmosphere config {config}")
  n, pool = ATMOSPHERE_ITERATIONS, 1 << 18
  reset_counts()
  torch.cuda.synchronize()
  t1 = time.perf_counter()
  sums, rays = path_tracing.render_samples_static(scene, config, 0, n, pool_size=pool, device=dev)
  int(rays.item())
  warm = time.perf_counter() - t1
  t1 = time.perf_counter()
  total = 0
  for rep in range(1, 1 + ATMOSPHERE_REPS):
    sums, rays = path_tracing.render_samples_static(scene, config, rep, n, pool_size=pool,
                                                    device=dev)
    total += int(rays.item())
  seconds = time.perf_counter() - t1
  counts = read_counts()
  img = film_mod.result_image(path_tracing.finalize_film(sums, n, config.film_width)).cpu().numpy()
  say("main", f"atmosphere {ATMOSPHERE_SIZE[0]}x{ATMOSPHERE_SIZE[1]} spectral mpl 8 pool 2^18: "
      f"staged in {staged:.2f} s (sky {config.num_env_emitters} distant emitters, "
      f"bank {tuple(scene.images.pixels.shape)}), frozen on the card in {built:.2f} s; warm-up "
      f"{n} spp {warm:.3f} s; {ATMOSPHERE_REPS} x {n} spp {seconds:.3f} s, {total} rays, "
      f"{total / seconds / 1e6:.3f} Mrays/s; launches {counts}")
  check(img.shape == (config.film_height, config.film_width, 3), f"image shape {img.shape}")
  check(bool(np.isfinite(img).all()), "atmosphere: image has non-finite values")
  y = img @ spectrum.RGB_TO_XYZ[1].astype(np.float64)
  check(float(y.min()) >= -1e-5 * max(1.0, float(img.max())),
        f"atmosphere: negative luminance {y.min()}")
  lo, hi = ATMOSPHERE_MEAN
  check(lo <= float(y.mean()) <= hi,
        f"atmosphere: mean luminance {float(y.mean())} outside [{lo}, {hi}]")
  negative = float((img < 0.0).any(axis=-1).mean())
  say("main", f"atmosphere image mean {float(img.mean()):.5f}, mean luminance "
      f"{float(y.mean()):.5f}, negative-channel pixels {negative:.4f}")
  for key in ("intersect", "occluded"):
    check(counts[key] > 0, f"the atmosphere main path never launched the {key} kernel")
  others = {k: c for k, c in counts.items() if c and k not in ("intersect", "occluded")}
  check(not others, f"the atmosphere main path launched {others}")
  return (scene, config), builder, counts


def captured_atmosphere(scene, config, dev):
  """K1 and K2 on the closest-hit and shadow rays of the atmosphere path's
  bounce 2, held bit-equal to their plain versions and timed beside their
  plain versions and bounds. Returns {kernel: row}."""
  closest, shadow = capture_bounce(scene, config, dev, CAPTURE_BOUNCE)
  geometry = (list(scene[:3]), None)
  return {name: hold_captured(f"the atmosphere main path's bounce {CAPTURE_BOUNCE}", name,
                              geometry, rays)
          for name, rays in (("intersect", closest), ("occluded", shadow))}


def main_path_showcase(dev):
  """The all-classes showcase through `render_samples_static` (see
  SHOWCASE_SIZE): staged on the host, SHOWCASE_ITERATIONS warm iterations
  and SHOWCASE_REPS timed repetitions of as many, the launch counts set to
  0 before the warm-up and read after the last repetition. Every trace
  goes to K3/K4. Gates the image: finite, no negative luminance, mean
  luminance inside SHOWCASE_MEAN. Returns ((scene, config), counts)."""
  t0 = time.perf_counter()
  scene, config = showcase_scene(SHOWCASE_SIZE, dev)
  torch.cuda.synchronize()
  staged = time.perf_counter() - t0
  check(config.spectral and config.material_classes == SHOWCASE_CLASSES
        and config.diffuse_variations == (0, 1, 2) and config.has_alpha and config.blue_noise
        and config.max_path_length == 16 and scene.tri_v0.shape[0] == SHOWCASE_TRIANGLES
        and scene.material_features == ("scattering_img", "roughness_img", "metalness_img", "normal_img")
        and path_tracing.uses_deferred_nee(config), f"showcase config {config}")
  n, pool = SHOWCASE_ITERATIONS, 1 << 18
  reset_counts()
  torch.cuda.synchronize()
  t1 = time.perf_counter()
  sums, rays = path_tracing.render_samples_static(scene, config, 0, n, pool_size=pool, device=dev)
  int(rays.item())
  warm = time.perf_counter() - t1
  t1 = time.perf_counter()
  total = 0
  for rep in range(1, 1 + SHOWCASE_REPS):
    sums, rays = path_tracing.render_samples_static(scene, config, rep, n, pool_size=pool,
                                                    device=dev)
    total += int(rays.item())
  seconds = time.perf_counter() - t1
  counts = read_counts()
  img = film_mod.result_image(path_tracing.finalize_film(sums, n, config.film_width)).cpu().numpy()
  say("main", f"shading showcase {SHOWCASE_SIZE[0]}x{SHOWCASE_SIZE[1]} spectral mpl 16 pool "
      f"2^18 blue noise: staged and frozen in {staged:.2f} s; warm-up {n} spp {warm:.3f} s; "
      f"{SHOWCASE_REPS} x {n} spp {seconds:.3f} s, {total} rays, "
      f"{total / seconds / 1e6:.3f} Mrays/s; launches {counts}")
  check(img.shape == (config.film_height, config.film_width, 3), f"image shape {img.shape}")
  check(bool(np.isfinite(img).all()), "showcase: image has non-finite values")
  y = img @ spectrum.RGB_TO_XYZ[1].astype(np.float64)
  check(float(y.min()) >= -1e-5 * max(1.0, float(img.max())),
        f"showcase: negative luminance {y.min()}")
  lo, hi = SHOWCASE_MEAN
  check(lo <= float(y.mean()) <= hi,
        f"showcase: mean luminance {float(y.mean())} outside [{lo}, {hi}]")
  say("main", f"showcase image mean {float(img.mean()):.5f}, mean luminance "
      f"{float(y.mean()):.5f} (CPU 64x64 {SHOWCASE_REFERENCE}), negative-channel pixels "
      f"{float((img < 0.0).any(axis=-1).mean()):.4f}")
  for key in ("intersect_brute2", "occluded_brute2"):
    check(counts[key] > 0, f"the showcase main path never launched the {key} kernel")
  others = {k: c for k, c in counts.items()
            if c and k not in ("intersect_brute2", "occluded_brute2")}
  check(not others, f"the showcase main path launched {others}")
  return (scene, config), counts


def render_small(build, dev_name: str, iterations: int, options=None):
  """A small render through `path_tracing.render`, or with `options`
  through `vcm.render`."""
  scene, config = build(dev_name)
  if options is None:
    fs = path_tracing.render(scene, config, iterations=iterations, device=dev_name)
  else:
    fs = vcm.render(scene, config, options, iterations=iterations, device=dev_name)
  return film_mod.result_image(fs).cpu().numpy()


def same_image(phase, label, img, ref):
  """`img` within E2E_OUTLIERS outlier pixels (off by more than 1e-4 +
  1e-3 |ref|) and E2E_MEAN_RTOL of the mean of `ref`."""
  out = np.abs(img - ref) > 1e-4 + 1e-3 * np.abs(ref)
  frac = float(out.any(axis=-1).mean())
  mean_rel = float(abs(img.mean(dtype=np.float64) - ref.mean(dtype=np.float64))
                   / abs(ref.mean(dtype=np.float64)))
  say(phase, f"{label}: outlier pixels {frac:.4f}, mean rel diff {mean_rel:.2e}, "
      f"max abs diff {float(np.abs(img - ref).max()):.3e}, reference mean {float(ref.mean()):.5f}")
  check(frac <= E2E_OUTLIERS, f"{label}: {frac} of pixels differ")
  check(mean_rel <= E2E_MEAN_RTOL, f"{label}: image means differ by {mean_rel}")


def card_vs_cpu(label, build, iterations, options=None):
  card = render_small(build, "cuda", iterations, options)
  cpu = render_small(build, "cpu", iterations, options)
  same_image("e2e", f"{label}, card vs CPU", card, cpu)
  return card


def end_to_end(atmosphere_32):
  """The 32x32 renders on the card against the same renders on the CPU
  (`atmosphere_32`: bench config 3's staged builder at 32x32)."""
  card = card_vs_cpu("cornell 32x32 golden config", lambda d: cornell_scene((32, 32), 6, d), 4)
  mean = card.mean(axis=(0, 1))
  total = float(card.sum())
  check(np.allclose(mean, GOLDEN_MEAN, rtol=GOLDEN_RTOL, atol=1e-5),
        f"card mean {mean} vs golden {GOLDEN_MEAN}")
  check(abs(total - GOLDEN_TOTAL) <= GOLDEN_RTOL * GOLDEN_TOTAL,
        f"card total {total} vs golden {GOLDEN_TOTAL}")
  say("e2e", f"card mean {mean}, total {total:.4f}: within rtol {GOLDEN_RTOL} of the golden values")
  card_vs_cpu("materials 32x32 spectral 4 spp", lambda d: materials_scene((32, 32), d), 4)

  reset_counts()
  card_vs_cpu("bigscene 32x32 8 spp (K5/K6)", lambda d: bigscene_scene((32, 32), d), 8)
  counts = read_counts()
  for key in ("intersect_bvh_fat", "occluded_bvh_fat"):
    check(counts[key] > 0, f"the bigscene 32x32 render never launched the {key} kernel")
  reset_counts()
  card_vs_cpu("bigscene 32x32 8 spp without fat rows (K7/K8)",
              lambda d: bigscene_scene((32, 32), d, fat_rows=False), 8)
  counts = read_counts()
  say("e2e", f"bigscene without fat rows: launches {counts}")
  for key in ("intersect_bvh", "occluded_bvh"):
    check(counts[key] > 0, f"the bigscene render without fat rows never launched the {key} kernel")
  check(counts["intersect_bvh_fat"] == 0 and counts["occluded_bvh_fat"] == 0,
        "the bigscene render without fat rows launched a fat-row kernel")
  for label, build, spp in IMAGE_E2E + ((
      "atmosphere spectral", lambda d: atmosphere_32.build(device=d), 4),):
    reset_counts()
    card_vs_cpu(f"{label} 32x32 {spp} spp", build, spp)
    counts = read_counts()
    say("e2e", f"{label}: launches {counts}")
    for key in ("intersect", "occluded"):
      check(counts[key] > 0, f"the {label} 32x32 render never launched the {key} kernel")
  for label, make, spp in MEDIA_E2E:
    reset_counts()
    card_vs_cpu(f"{label} 32x32 {spp} spp", lambda d: make().build(device=d), spp)
    counts = read_counts()
    say("e2e", f"{label}: launches {counts}")
    check(counts["intersect"] > 0, f"the {label} 32x32 render never launched the intersect kernel")
  for label, make, options, iterations, want in VCM_E2E + SHADING_E2E:
    reset_counts()
    card_vs_cpu(f"{label} {iterations} iterations", make, iterations, options)
    counts = read_counts()
    launched = {k: n for k, n in counts.items() if n}
    say("e2e", f"{label}: launches {launched}")
    check(set(launched) == set(want), f"the {label} 32x32 render launched {launched}, not {want}")


def gate_cli_image(label, path, bounds, size):
  """An EXR the CLI wrote, read back: finite, of the film's size, >= 0, its
  mean inside `bounds`, red left third and green right third."""
  img = image_io.load_exr(str(path))
  check(img.shape == (size[1], size[0], 3), f"{label}: image shape {img.shape}")
  check(bool(np.isfinite(img).all()), f"{label}: image has non-finite values")
  return gate_mean(label, img, bounds)


class Rays:
  """Sums, while it is entered, the rays that the PT drivers `names` of
  `path_tracing` return, and records the active-pixel count of each map."""

  def __init__(self, names=("render_samples", "render_samples_mapped")):
    self.names = names

  def __enter__(self):
    self.rays, self.active = 0, []
    self._saved = {name: getattr(path_tracing, name)
                   for name in (*self.names, "active_pixel_map")}

    def counted(fn):
      def driver(*args, **kwargs):
        sums, rays = fn(*args, **kwargs)
        self.rays += int(rays.item())
        return sums, rays
      return driver

    def mapped(*args, **kwargs):
      pmap, n_active = self._saved["active_pixel_map"](*args, **kwargs)
      self.active.append(int(n_active.item()))
      return pmap, n_active

    for name in self.names:
      setattr(path_tracing, name, counted(self._saved[name]))
    path_tracing.active_pixel_map = mapped
    return self

  def __exit__(self, *exc):
    for name, fn in self._saved.items():
      setattr(path_tracing, name, fn)


def cli_adaptive_card_vs_cpu(scene_file, dev):
  """The adaptive render's map and one mapped batch, card against CPU: the
  CPU's 32 warm spp of the scene files at CLI_MAP_SIZE and
  CLI_MAP_PATH_LENGTH, its map at
  CLI_MAP_THRESHOLD built on the card and on the CPU from those sums (equal
  ids and count), then one batch of 8 spp over that map from those sums on
  both (the sample counts equal, the sums within the end-to-end
  tolerances: index_add on the card adds a pixel's rows in atomic order)."""
  b = json_scene.load_scene(scene_file)
  b.film_size, b.max_path_length = CLI_MAP_SIZE, CLI_MAP_PATH_LENGTH
  scene, config = b.build(device="cpu")
  width, npix = CLI_MAP_SIZE[0], CLI_MAP_SIZE[0] * CLI_MAP_SIZE[1]
  sums, _ = path_tracing.render_samples(scene, config, 0, 32, device="cpu")
  pmap, n_cpu = path_tracing.active_pixel_map(sums, width, CLI_MAP_THRESHOLD)
  card_sums = path_tracing.FilmSums(sums.table.to(dev))
  card_map, n_card = path_tracing.active_pixel_map(card_sums, width, CLI_MAP_THRESHOLD)
  check(int(n_card.item()) == int(n_cpu) and torch.equal(card_map.cpu(), pmap),
        "active_pixel_map: the card's map differs from the CPU's on the same sums")
  check(0 < int(n_cpu) < npix, f"the {width}x{width} map at {CLI_MAP_THRESHOLD} is not "
        f"partial: {int(n_cpu)} of {npix} pixels active")
  cpu, _ = path_tracing.render_samples_mapped(scene, config, pmap, 32, 8, sums, device="cpu")
  card, _ = path_tracing.render_samples_mapped(scene, config, pmap, 32, 8, sums, device=dev)
  got, want = card.table.cpu().numpy(), cpu.table.numpy()
  check(np.array_equal(got[:, 12:14], want[:, 12:14]),
        "render_samples_mapped: sample counts differ between the card and the CPU")
  for lo, hi, layer in ((0, 3, "camera"), (3, 6, "normals"), (6, 9, "albedo"),
                        (9, 12, "variance")):
    shape = (CLI_MAP_SIZE[1], CLI_MAP_SIZE[0], 3)
    same_image("cli", f"render_samples_mapped {width}x{width} {layer} sums, card vs CPU",
               got[:, lo:hi].reshape(shape), want[:, lo:hi].reshape(shape))
  say("cli", f"active_pixel_map {width}x{width} at {CLI_MAP_THRESHOLD}: card equal to the CPU on "
      f"the CPU's 32 warm spp ({int(n_cpu)} of {npix} pixels active)")


def cli_phase(dev):
  """The CLI on the Cornell scene files: PT through the module entry in a
  subprocess (its launch counts from its log), then `--adaptive` and two
  debug AOVs through `cli.main` in this process with the launch counts set
  to 0 before each and read after. Each EXR is read back and gated. Then
  the adaptive map and a mapped batch card against CPU. Returns
  ({run: launch counts}, the scene file)."""
  work = Path(_build.BUILD_DIR) / "cli"
  shutil.rmtree(work, ignore_errors=True)
  work.mkdir(parents=True)
  os.environ["ETX_TPU_CONFIG_DIR"] = str(work / "prefs")
  scene_file = assets.write_cornell_asset(str(work / "scene"))
  b = json_scene.load_scene(scene_file)
  size = b.film_size
  check(size == (640, 640) and b.samples == CLI_SPP and b.max_path_length == 1023,
        f"scene files: {size}, {b.samples} spp, path length {b.max_path_length}")
  out = {}

  pt_exr = work / "pt.exr"
  t0 = time.perf_counter()
  proc = subprocess.run([sys.executable, "-m", "etx_tracer_tpu_torch.cli", "render", scene_file,
                         "-o", str(pt_exr), "--spp", str(CLI_PT_SPP)],
                        cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True,
                        timeout=600)
  seconds = time.perf_counter() - t0
  check(proc.returncode == 0, f"cli render exited {proc.returncode}:\n{proc.stderr[-3000:]}")
  for line in proc.stderr.splitlines():
    say("cli", f"  {line}")
  found = re.search(r"trace kernel launches: (\{.*\})", proc.stderr)
  check(found is not None, "cli render printed no launch counts")
  launched = json.loads(found.group(1))
  counts = {"intersect": launched.get("brute_trace.intersect", 0),
            "occluded": launched.get("brute_trace.occluded", 0)}
  check(counts["intersect"] > 0 and counts["occluded"] > 0
        and set(launched) == {"brute_trace.intersect", "brute_trace.occluded"},
        f"cli render: the PT path launched {launched}, not K1 and K2")
  mean = gate_cli_image("cli render (pt)", pt_exr, CLI_PT_MEAN, size)
  say("cli", f"python -m etx_tracer_tpu_torch.cli render {size[0]}x{size[1]} {CLI_PT_SPP} spp: "
      f"{seconds:.3f} s of subprocess (interpreter, imports, scene files and render), launches "
      f"K1 {counts['intersect']} / K2 {counts['occluded']}, image mean {mean:.5f}")
  out["pt"] = counts

  runs = [("adaptive", ["--adaptive", "--spp", str(CLI_ADAPTIVE_SPP)], CLI_ADAPTIVE_MEAN),
          *((f"debug {aov}", ["--integrator", "debug", "--aov", aov], CLI_DEBUG_MEANS[aov])
            for aov in ("normals", "albedo"))]
  for label, extra, bounds in runs:
    exr = work / f"{label.replace(' ', '_')}.exr"
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Rays() as rays:
      cli.main(["render", scene_file, "-o", str(exr), *extra])
    seconds = time.perf_counter() - t0
    counts = read_counts()
    launched = {k: n for k, n in counts.items() if n}
    mean = gate_cli_image(f"cli render ({label})", exr, bounds, size)
    if label == "adaptive":
      check(counts["intersect"] > 0 and counts["occluded"] > 0 and set(launched) <= {
          "intersect", "occluded"}, f"cli render --adaptive launched {launched}")
      check(len(rays.active) == (CLI_ADAPTIVE_SPP - 32) // 8 and all(rays.active),
            f"adaptive batches: active pixels {rays.active}")
      detail = (f"{rays.rays} rays, {rays.rays / seconds / 1e6:.3f} Mrays/s, active pixels a "
                f"batch {rays.active}")
    else:
      check(launched == {"intersect": 1}, f"cli render ({label}) launched {launched}, not one K1")
      detail = "one closest-hit launch"
    say("cli", f"cli.main render {' '.join(extra)} {size[0]}x{size[1]}: {seconds:.3f} s, "
        f"{detail}, launches {launched}, image mean {mean:.5f}")
    out[label] = counts
  cli_adaptive_card_vs_cpu(scene_file, dev)
  return out, scene_file


# ---------------------------------------------------------------------------
# The sharding slice: ranks, --devices, the viewer, the validating build
# ---------------------------------------------------------------------------


def gloo_collectives(mesh) -> dict:
  """Which collectives gloo takes on this rank's CUDA tensors: {name: "ok"
  or the first line of its error}. Every rank calls them in one order."""
  import torch.distributed as dist
  w = mesh.world
  x = torch.arange(4, dtype=torch.float32, device=mesh.device) + mesh.rank
  calls = {
      "all_reduce": lambda: dist.all_reduce(x.clone()),
      "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(w)], x),
      "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
          torch.empty(4 * w, device=mesh.device), x),
      "broadcast": lambda: dist.broadcast(x.clone(), src=0),
      "reduce": lambda: dist.reduce(x.clone(), dst=0),
      "gather": lambda: dist.gather(x, [torch.empty_like(x) for _ in range(w)]
                                    if mesh.rank == 0 else None, dst=0),
      "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
          torch.empty(4, device=mesh.device), torch.ones(4 * w, device=mesh.device)),
  }
  out = {}
  for name, call in calls.items():
    try:
      call()
      torch.cuda.synchronize(mesh.device)
      out[name] = "ok"
    except (RuntimeError, ValueError, NotImplementedError) as e:
      out[name] = str(e).strip().splitlines()[0][:120]
  return out


def sharded_cornell_job(mesh, scene, config, spp: int) -> dict:
  """A rank of the sharded Cornell phase: the wall time it started (after
  joining the group), gloo's collectives on CUDA tensors where they apply,
  then `mesh.render_samples_job`."""
  started = time.time()
  probe = (gloo_collectives(mesh) if mesh.backend == "gloo" and mesh.device.type == "cuda"
           else None)
  return pmesh.render_samples_job(mesh, scene, config, 0, spp) | {"started": started,
                                                                   "collectives": probe}


def sharded_vcm_job(mesh, small, big, iterations: int) -> dict:
  """A rank of the sharded caustics phase: one uncapped iteration of the
  small film, then `iterations` capped ones at full width."""
  started = time.time()
  uncapped = pmesh.iterations_job(mesh, *small, 0, 1, _UNCAPPED)
  capped = pmesh.iterations_job(mesh, *big, 0, iterations, vcm.VCMOptions())
  return {"started": started, "uncapped": uncapped, "capped": capped}


def rank_lines(phase, label, ranks, t_launch):
  """Print each rank's seconds, rays and launches and the seconds to spawn
  and join their group."""
  spawn = max(r["started"] for r in ranks) - t_launch
  for r in ranks:
    report = r.get("capped", r)
    say(phase, f"{label} rank {report['rank']} ({report['device']}): "
        f"{report['seconds']:.3f} s, " + (f"{r['rays']} rays, " if "rays" in r else "")
        + f"launches {report['launches']}")
  say(phase, f"{label}: {len(ranks)} rank(s) spawned and joined their group in {spawn:.3f} s")


def sharded_cornell_phase(dev):
  """The main path's Cornell at SHARDED_SPP spp through
  `render_samples_sharded` on SHARDED_GLOO_RANKS gloo ranks that share the
  card, then on a NCCL world of 1, each held against the single-device
  render of the same samples on the card and gated. Returns the ranks'
  K1/K2 launches by run."""
  scene_cpu, config = cornell_scene((512, 512), 1023, "cpu")
  scene = scene_types.to_device(scene_cpu, dev)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  sums, rays = path_tracing.render_samples_static(scene, config, 0, SHARDED_SPP,
                                                  pool_size=1 << 18, device=dev)
  single = path_tracing.finalize_film(sums, SHARDED_SPP, config.film_width).camera.cpu().numpy()
  say("sharded", f"single-device cornell 512x512 {SHARDED_SPP} spp: "
      f"{time.perf_counter() - t0:.3f} s, {int(rays.item())} rays")
  del scene, sums
  torch.cuda.empty_cache()
  out = {}
  for label, backend, world in ((f"gloo x{SHARDED_GLOO_RANKS} on one card", "gloo",
                                 SHARDED_GLOO_RANKS), ("nccl x1", "nccl", 1)):
    t_launch = time.time()
    ranks = pmesh.launch(sharded_cornell_job, world, backend, ["cuda:0"] * world, SPAWN_TIMEOUT,
                         args=(scene_cpu, config, SHARDED_SPP))
    wall = time.time() - t_launch
    rank_lines("sharded", f"cornell {label}", ranks, t_launch)
    if ranks[0]["collectives"] is not None:
      say("sharded", f"gloo collectives on CUDA tensors: {ranks[0]['collectives']}")
    for r in ranks:
      check(set(r["launches"]) == {"brute_trace.intersect", "brute_trace.occluded"},
            f"cornell {label} rank {r['rank']} launched {r['launches']}, not K1 and K2")
    img = path_tracing.finalize_film(path_tracing.FilmSums(torch.from_numpy(ranks[0]["table"])),
                                     SHARDED_SPP, config.film_width).camera.numpy()
    check(img.shape == (512, 512, 3) and bool(np.isfinite(img).all()),
          f"cornell {label}: image {img.shape}, finite {bool(np.isfinite(img).all())}")
    same_image("sharded", f"cornell {label} vs single device", img, single)
    mean = gate_mean(f"sharded cornell {label}", img, (0.05, 0.15))
    say("sharded", f"cornell {label}: {wall:.3f} s of launch, {ranks[0]['rays_total']} rays "
        f"(padded rows included), mean {mean:.5f}")
    out[label] = {k: sum(r["launches"].get(f"brute_trace.{k}", 0) for r in ranks)
                  for k in ("intersect", "occluded")}
  return out


def sharded_caustics_phase(dev):
  """Bench config 5 by VCM on SHARDED_VCM_RANKS gloo ranks that share the
  card: one uncapped 32x32 iteration held against the single-device one on
  the card, then SHARDED_VCM_ITERATIONS capped iterations at 256x256, gated
  as the caustics main path. Returns the ranks' K3/K4 launches."""
  small = caustics.build_caustics_scene(SHARDED_VCM_SMALL).build(device="cpu")
  big = caustics.build_caustics_scene(VCM_SIZE).build(device="cpu")
  fs = film_mod.allocate(*SHARDED_VCM_SMALL, dev)
  single = film_mod.result_image(vcm.render_iteration(*small, _UNCAPPED, fs, 0, device=dev))
  single = single.cpu().numpy()
  torch.cuda.empty_cache()
  t_launch = time.time()
  ranks = pmesh.launch(sharded_vcm_job, SHARDED_VCM_RANKS, "gloo",
                       ["cuda:0"] * SHARDED_VCM_RANKS, SPAWN_TIMEOUT,
                       args=(small, big, SHARDED_VCM_ITERATIONS))
  wall = time.time() - t_launch
  label = f"caustics VCM gloo x{SHARDED_VCM_RANKS} on one card"
  rank_lines("sharded", label, ranks, t_launch)
  for r in ranks:
    for run in ("uncapped", "capped"):
      check(set(r[run]["launches"]) == {"brute2_trace.intersect", "brute2_trace.occluded"},
            f"{label} rank {r[run]['rank']} ({run}) launched {r[run]['launches']}, not K3 and K4")
  film = ranks[0]["uncapped"]["film"]
  same_image("sharded", f"{label} 32x32 uncapped vs single device",
             film["camera"] + film["light"], single)
  film = ranks[0]["capped"]["film"]
  img = film["camera"] + film["light"]
  check(img.shape == (VCM_SIZE[1], VCM_SIZE[0], 3) and bool(np.isfinite(img).all()),
        f"{label}: image {img.shape}, finite {bool(np.isfinite(img).all())}")
  lum = spectrum.RGB_TO_XYZ[1].astype(np.float64)
  y_light = film["light"] @ lum
  check(float(y_light.min()) >= -1e-5 * max(1.0, float(img.max())),
        f"{label}: negative light-layer luminance {y_light.min()}")
  mean = float(img.mean())
  lo, hi = CAUSTICS_VCM_MEAN
  check(lo <= mean <= hi, f"{label}: image mean {mean} outside [{lo}, {hi}]")
  left, right = check_thirds(img, label)
  say("sharded", f"{label} 256x256: " + ", ".join(
      f"rank {r['capped']['rank']} {r['capped']['seconds'] / SHARDED_VCM_ITERATIONS:.3f} s an "
      f"iteration (32x32 uncapped {r['uncapped']['seconds']:.3f} s)" for r in ranks))
  say("sharded", f"{label} 256x256, {SHARDED_VCM_ITERATIONS} iterations: {wall:.3f} s of launch "
      f"(both runs), mean {mean:.5f}, left third RGB {left}, right third RGB {right}")
  return {k: sum(r["capped"]["launches"].get(f"brute2_trace.{k}", 0) for r in ranks)
          for k in ("intersect", "occluded")}


def devices_phase(scene_file):
  """`cli render --devices 2` on the Cornell scene files in a subprocess:
  one card is visible, so the CLI says so and runs a NCCL world of 1;
  gated as the CLI phase's PT. Returns its K1/K2 launches."""
  out_exr = Path(scene_file).parent.parent / "devices.exr"
  t0 = time.perf_counter()
  proc = subprocess.run([sys.executable, "-m", "etx_tracer_tpu_torch.cli", "render", scene_file,
                         "-o", str(out_exr), "--devices", "2", "--spp", str(DEVICES_SPP)],
                        cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True,
                        timeout=SPAWN_TIMEOUT)
  seconds = time.perf_counter() - t0
  check(proc.returncode == 0, f"cli render --devices 2 exited {proc.returncode}:\n"
        f"{proc.stderr[-3000:]}")
  for line in proc.stderr.splitlines():
    say("devices", f"  {line}")
  check("only 1 device(s) visible; using 1" in proc.stderr and "1 nccl rank(s)" in proc.stderr,
        "cli render --devices 2 did not say it runs one NCCL rank")
  found = re.search(r"trace kernel launches: (\{.*\})", proc.stderr)
  check(found is not None, "cli render --devices 2 printed no launch counts")
  launched = json.loads(found.group(1))
  check(set(launched) == {"brute_trace.intersect", "brute_trace.occluded"},
        f"cli render --devices 2 launched {launched}, not K1 and K2")
  b = json_scene.load_scene(scene_file)
  mean = gate_cli_image("cli render --devices 2", out_exr, CLI_PT_MEAN, b.film_size)
  say("devices", f"python -m etx_tracer_tpu_torch.cli render --devices 2 --spp {DEVICES_SPP} "
      f"{b.film_size[0]}x{b.film_size[1]}: {seconds:.3f} s of subprocess, launches {launched}, "
      f"image mean {mean:.5f}")
  return {k: launched[f"brute_trace.{k}"] for k in ("intersect", "occluded")}


def _free_port() -> int:
  import socket
  with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1]


def viewer_phase(work: Path):
  """`cli view cornell --size 512x512` in a subprocess, driven over HTTP as
  a browser does. Returns its K1/K2 launches."""
  import urllib.request
  port = _free_port()
  base = f"http://127.0.0.1:{port}"
  log = open(work / "viewer.log", "w+")
  t0 = time.perf_counter()
  proc = subprocess.Popen([sys.executable, "-m", "etx_tracer_tpu_torch.cli", "view", "cornell",
                           "--size", f"{VIEWER_SIZE[0]}x{VIEWER_SIZE[1]}", "--port", str(port)],
                          cwd=str(Path(__file__).resolve().parent), stdout=log,
                          stderr=subprocess.STDOUT)
  deadline = time.monotonic() + VIEWER_TIMEOUT

  def get(route):
    return urllib.request.urlopen(base + route, timeout=30).read()

  def post(route, data):
    req = urllib.request.Request(base + route, data=json.dumps(data).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=30).read()

  def wait(what, cond):
    while True:
      check(proc.poll() is None, f"viewer exited with {proc.returncode} while waiting for {what}")
      check(time.monotonic() < deadline, f"viewer: no {what} within {VIEWER_TIMEOUT} s")
      try:
        s = json.loads(get("/status"))
      except OSError:  # not serving yet
        time.sleep(0.2)
        continue
      check(s["error"] is None, f"viewer render thread died:\n{s['error']}")
      if cond(s):
        return s
      time.sleep(0.05)

  try:
    s = wait("first frame", lambda s: s["frames"] >= 1)
    first = time.perf_counter() - t0
    s = wait(f"{VIEWER_ITERATIONS} iterations",
             lambda s: s["iteration"] >= VIEWER_ITERATIONS and not s["preview"])
    say("viewer", f"first frame {first:.3f} s after the start (interpreter, imports, scene, "
        f"preview), {s['iteration']} iterations {time.perf_counter() - t0:.3f} s after; preview "
        f"{s['preview_seconds']:.3f} s, iteration {s['iteration_seconds']:.3f} s (pt, "
        f"{VIEWER_SIZE[0]}x{VIEWER_SIZE[1]})")
    # the result layer's float values, written here and gated as the CLI's
    exr = work / "viewer.exr"
    image_io.save_exr(str(exr), np.load(io.BytesIO(get("/frame?layer=result&format=npy"))))
    mean = gate_cli_image("viewer result", exr, VIEWER_MEAN, VIEWER_SIZE)
    for layer in ("result", "normals", "noise", "denoised"):
      png = image_io.decode_png(get(f"/frame?layer={layer}&exposure=1"))
      check(png.shape == (VIEWER_SIZE[1], VIEWER_SIZE[0], 4), f"viewer {layer}: {png.shape}")
    # a camera move: previews at 1/8 resolution, then accumulation restarts
    before = s
    post("/camera", {"orbit": [40, 0]})
    s = wait("a preview after the orbit", lambda s: s["previews"] > before["previews"])
    # a preview resets the iteration count: accumulation restarts
    check(s["iteration"] == 0, f"viewer: iteration {s['iteration']} after the orbit's preview")
    blocky = None
    while blocky is None and time.monotonic() < deadline:
      s1 = json.loads(get("/status"))
      png = image_io.decode_png(get("/frame?layer=result&exposure=1"))
      s2 = json.loads(get("/status"))
      if s1["frames"] != s2["frames"]:
        continue  # the frame changed while it was read
      # a preview frame carries iteration 0 until the first iteration replaces it
      check(s1["iteration"] == 0, "viewer: accumulation went on before a preview frame was read")
      blocks = png.reshape(VIEWER_SIZE[1] // 8, 8, VIEWER_SIZE[0] // 8, 8, 4)
      blocky = bool((blocks == blocks[:, :1, :, :1]).all())
    check(blocky is True, f"viewer: the preview frame is not in 8x8 blocks ({blocky})")
    s = wait("an iteration after the orbit", lambda s: s["iteration"] >= 1 and not s["preview"])
    say("viewer", f"orbit: {s['previews'] - before['previews']} preview(s) at 1/8 resolution "
        f"(8x8 blocks), accumulation restarted from iteration {before['iteration']} to "
        f"{s['iteration']}; preview {s['preview_seconds']:.3f} s")
    post("/options", {"integrator": "vcm"})
    s = wait("a VCM iteration",
             lambda s: s["integrator"] == "vcm" and s["iteration"] >= 1 and not s["preview"])
    launched = {k: n for k, n in s["launches"].items() if n}
    check(set(launched) == {"brute_trace.intersect", "brute_trace.occluded"},
          f"viewer launched {launched}, not K1 and K2")
    say("viewer", f"vcm: iteration {s['iteration_seconds']:.3f} s; result mean {mean:.5f}; "
        f"launches in the viewer process {launched}")
    return {k: launched[f"brute_trace.{k}"] for k in ("intersect", "occluded")}
  finally:
    proc.terminate()
    try:
      proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
      proc.kill()
      proc.wait(timeout=30)
    log.seek(0)
    for line in log.read().splitlines()[-20:]:
      say("viewer", f"  {line}")
    log.close()


def validate_phase(dev):
  """The validating build on a VALIDATE_SIZE diffuse Cornell box: with the
  red wall's reflectance set to NaN it must raise naming a `pt:` stage; the
  clean scene passes; its extra seconds and host reads a bounce against
  the production build."""
  scene, config = cornell_scene(VALIDATE_SIZE, 1023, dev)
  checked_config = dataclasses.replace(config, validate=True)
  path_tracing.render(scene, config, iterations=VALIDATE_SPP, device=dev)  # warm-up
  runs = {}
  for label, cfg in (("production", config), ("validating", checked_config)):
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Counting() as counting:
      img = film_mod.result_image(path_tracing.render(scene, cfg, iterations=VALIDATE_SPP,
                                                      device=dev))
      torch.cuda.synchronize()
    runs[label] = (time.perf_counter() - t0, counting.bounces, counting.host_reads, read_counts(),
                   img.cpu().numpy())
  (ps, pb, pr, pc, pimg), (vs, vb, vr, vc, vimg) = runs["production"], runs["validating"]
  check(pc == vc and pb == vb, f"validating build: launches {vc} and bounces {vb} against {pc} "
        f"and {pb}")
  check(bool(np.array_equal(pimg, vimg)) or bool(np.allclose(pimg, vimg, rtol=1e-6, atol=1e-7)),
        "validating build changed the image")
  rgb = scene.spec_rgb.clone()
  red = (rgb == torch.tensor([1.0, 0.0, 0.0], device=dev)).all(dim=-1)
  check(int(red.sum().item()) == 1, "validating build: no single red reflectance")
  rgb[red] = float("nan")
  try:
    path_tracing.render(scene._replace(spec_rgb=rgb), checked_config, iterations=1, device=dev)
    raised = None
  except validate.ValidationError as e:
    raised = str(e)
  check(raised is not None and raised.startswith("non-finite in pt:"),
        f"validating build on a NaN reflectance: {raised}")
  say("validate", f"{VALIDATE_SIZE[0]}x{VALIDATE_SIZE[1]} {VALIDATE_SPP} spp: production "
      f"{ps:.3f} s, validating {vs:.3f} s (+{vs - ps:.3f} s), {pb} bounces, host reads a bounce "
      f"{pr / pb:.2f} -> {vr / vb:.2f}, launches equal {({k: n for k, n in pc.items() if n})}; NaN reflectance raised "
      f"\"{raised}\"")


def micro_phase(dev):
  """The micro-benchmark entry's four trace groups at full width, each with
  the launch counts set to 0 just before it and read just after; checks
  that every line went through its kernels and that the kernels agree:
  K5 and K1 give equal t (one triangle test), the sorted and oracle orders
  give each ray the unsorted hit, and K9a agrees with K3. Returns the
  launch counts of `trace_brute`, the path that runs K9a/K9b."""
  wants = {"trace": ("intersect_bvh_fat", "intersect"),
           "trace_brute": ("intersect_brute2", "occluded_brute2", "intersect_woop",
                           "occluded_woop"),
           "trace_sorted": ("intersect_bvh_fat",), "trace_oracle": ("intersect_bvh_fat",),
           "sort": (), "mxu": (), "dispatch": ("intersect_brute2",),
           "step": ("intersect_brute2", "occluded_brute2")}
  lines, counts = {}, {}
  for group, want in wants.items():
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = micro.run(group, dev)
    torch.cuda.synchronize()
    counts[group] = read_counts()
    launched = {k: n for k, n in counts[group].items() if n}
    say("micro", f"{group}: {len(out)} lines in {time.perf_counter() - t0:.1f} s, "
        f"launches {launched}")
    check(set(launched) == set(want), f"micro {group} launched {launched}, not {want}")
    check(all(np.isfinite(x.seconds) and x.seconds > 0.0 for x in out),
          f"micro {group}: a step time is not a positive number")
    lines[group] = {x.label: x for x in out}

  big = micro.scene("bigscene", str(dev))
  for kind in ("primary", "bounce", "random"):
    fat, brute = (lines["trace"][f"{k} {kind}"].result for k in ("fat", "brute"))
    check(torch.equal(fat.t, brute.t), f"micro trace {kind}: K5 and K1 give other t")
    # the kernels' device time per launch on the group's rays, by CUDA
    # events around back-to-back calls (one launch a call, no chained ops)
    rays = micro._rays(big, micro.SIZES["trace"], kind, dev)
    k5_ms = event_ms(lambda: bvh_trace.intersect_fat(big.bvh, *rays), 20)
    k1_ms = event_ms(lambda: brute_trace.intersect(*big[:3], *rays), 5)
    say("micro", f"trace {kind}: K5 {k5_ms:.4f} ms and K1 {k1_ms:.4f} ms per call (events); "
        f"equal t, equal tri {(fat.tri == brute.tri).float().mean().item():.5f}, hit fraction "
        f"{fat.found.float().mean().item():.4f}")
  for kind in ("bounce", "random"):
    o, d, t_min, t_max = micro._rays(big, micro.SIZES["trace_sorted"], kind, dev)
    want = bvh_trace.intersect_fat(big.bvh, o, d, t_min, t_max)
    got = lines["trace_sorted"][f"fat+sort {kind}"].result
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"micro trace_sorted {kind}: the sorted trace gives other hits")
    for name, key in micro.oracle_keys(big.bvh, o, d, want):
      perm = torch.argsort(key, stable=True)
      got = lines["trace_oracle"][f"oracle[{name}] {kind}"].result
      check(all(torch.equal(a, b[perm]) for a, b in zip(got, want)),
            f"micro trace_oracle[{name}] {kind}: the sorted rays give other hits")
  for name in micro.SCENES:
    k3, k9 = (lines["trace_brute"][f"{name} {k} closest"].result for k in ("brute2", "woop"))
    o3, o9 = (lines["trace_brute"][f"{name} {k} anyhit"].result for k in ("brute2", "woop"))
    same = k3.tri == k9.tri
    both = same & k3.found
    rel = ((k9.t - k3.t).abs() / k3.t.abs())[both]
    max_rel = rel.max().item() if rel.numel() else 0.0
    close = (rel <= 1e-4).float().mean().item() if rel.numel() else 1.0
    share = same.float().mean().item()
    say("micro", f"trace_brute {name}: K9a vs K3 equal tri {share:.6f} "
        f"({int((~same).sum())} of {same.numel()} rays differ), largest relative |dt| "
        f"{max_rel:.3e} where equal ({close:.6f} of them within 1e-4); K9b vs K4 equal "
        f"{(o3 == o9).float().mean().item():.6f}; hit fraction "
        f"{k3.found.float().mean().item():.4f}")
    # two formulations of one test: they part only at edges, ties and
    # grazing angles, where t = -w_z / q_z divides by a small cosine
    check(share >= 0.99 and close >= 0.999,
          f"trace_brute {name}: K9a and K3 disagree (equal tri {share}, t within 1e-4 {close})")
  return counts["trace_brute"]


def woop_matmul_note(dev):
  """For comparison only (the port never calls it): one FP32 `torch.matmul`
  of the (R, 8) x (8, 6 x 512) product per 512-triangle chunk, the part of
  K9a that the TPU kernel hands to its matrix unit, at 2^18 rays, TF32 off."""
  torch.backends.cuda.matmul.allow_tf32 = False
  ray8 = torch.randn(RAYS, 8, device=dev)
  chunk = torch.randn(8, 6 * woop_trace.CHUNK, device=dev)
  out = torch.empty(RAYS, 6 * woop_trace.CHUNK, device=dev)
  for name, num_t in (("materials", 996), ("bigscene", bigscene.NUM_TRIANGLES)):
    chunks = -(-num_t // woop_trace.CHUNK)

    def product():
      for _ in range(chunks):
        torch.matmul(ray8, chunk, out=out)

    ms = event_ms(product, 3)
    say("woop_matmul", f"{name}: {chunks} x FP32 matmul (2^18, 8) x (8, {6 * woop_trace.CHUNK}) "
        f"{ms:.4f} ms (TF32 off)")

# ---------------------------------------------------------------------------
# The walks, the native library, NanoVDB, the micro groups, the denoiser
# ---------------------------------------------------------------------------


class Walks:
  """The lobes' multiple-scattering backend set to `backend` (default the
  Heitz walks) while it is entered, and set back after."""

  def __init__(self, backend="walk"):
    self.backend = backend

  @classmethod
  def off(cls):
    return cls("lut")

  def __enter__(self):
    self._saved, lobes.MS_BACKEND = lobes.MS_BACKEND, self.backend
    return self

  def __exit__(self, *exc):
    lobes.MS_BACKEND = self._saved


def profile_bounce(label, scene, config, dev):
  """The first bounce of iteration 0 (every lane alive), run once to warm
  up and once under the profiler: its kernels, host reads and device time.
  One bounce keeps the profiler's records few (an iteration of a walked
  scene is about a million)."""
  from torch.profiler import ProfilerActivity, profile
  state = path_tracing.make_payload(scene, config, 0, device=dev)
  path_tracing.pt_step(scene, config, state)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof, Counting() as counted:
    t0 = time.perf_counter()
    path_tracing.pt_step(scene, config, state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  busy_us, launched, _ = device_summary(prof)
  say("profile", f"{label}, bounce 1 of {state.ray_o.shape[0]} lanes: {wall_ms:.1f} ms wall, "
      f"device busy {busy_us / 1e3:.1f} ms, {launched} kernels, {counted.host_reads} host reads")


def walk_phase(dev):
  """The shading showcase at SHOWCASE_SIZE under the walks (its Principled
  material walks all three lobes, its Plastic the plastic walk) through
  K3/K4: WALK_ITERATIONS warm and WALK_ITERATIONS timed iterations, the
  launch counts set to 0 before the warm-up and read after; gated (finite,
  no negative luminance, mean luminance within WALK_SHOWCASE_MEAN); the
  first bounce at WALK_PROFILE_SIZE profiled under the walks and under the
  LUT (kernels and host reads); then the walked showcase and the walked
  materials scene (its rough gold conductor walks) at 32x32, card against
  CPU.
  Returns the launch counts."""
  with Walks():
    t0 = time.perf_counter()
    scene, config = showcase_scene(SHOWCASE_SIZE, dev)
    staged_s = time.perf_counter() - t0
    n, pool = WALK_ITERATIONS, 1 << 18
    reset_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sums, rays = path_tracing.render_samples_static(scene, config, 0, n, pool_size=pool, device=dev)
    int(rays.item())
    warm = time.perf_counter() - t1
    t1 = time.perf_counter()
    sums, rays = path_tracing.render_samples_static(scene, config, n, n, pool_size=pool, device=dev)
    total = int(rays.item())
    seconds = time.perf_counter() - t1
    counts = read_counts()
    img = film_mod.result_image(path_tracing.finalize_film(sums, n, config.film_width)).cpu().numpy()
    say("walk", f"shading showcase under the walks {SHOWCASE_SIZE[0]}x{SHOWCASE_SIZE[1]} spectral "
        f"mpl 16 pool 2^18 blue noise: staged in {staged_s:.2f} s; warm-up {n} spp {warm:.3f} s; "
        f"{n} spp {seconds:.3f} s, {total} rays, {total / seconds / 1e6:.3f} Mrays/s; "
        f"launches {counts}")
    check(bool(np.isfinite(img).all()), "walked showcase: image has non-finite values")
    y = img @ spectrum.RGB_TO_XYZ[1].astype(np.float64)
    check(float(y.min()) >= -1e-5 * max(1.0, float(img.max())),
          f"walked showcase: negative luminance {y.min()}")
    lo, hi = WALK_SHOWCASE_MEAN
    check(lo <= float(y.mean()) <= hi,
          f"walked showcase: mean luminance {float(y.mean())} outside [{lo}, {hi}]")
    say("walk", f"walked showcase image mean {float(img.mean()):.5f}, mean luminance "
        f"{float(y.mean()):.5f} (CPU 64x64 {WALK_SHOWCASE_REFERENCE})")
    check(counts["intersect_brute2"] > 0 and counts["occluded_brute2"] > 0
          and not {k for k, c in counts.items() if c} - {"intersect_brute2", "occluded_brute2"},
          f"the walked showcase launched {counts}")
    del scene, sums
    profile_bounce(f"walked showcase {WALK_PROFILE_SIZE[0]}x{WALK_PROFILE_SIZE[1]}",
                   *showcase_scene(WALK_PROFILE_SIZE, dev), dev)
    with Walks.off():
      profile_bounce(f"LUT showcase {WALK_PROFILE_SIZE[0]}x{WALK_PROFILE_SIZE[1]}",
                     *showcase_scene(WALK_PROFILE_SIZE, dev), dev)
    card_vs_cpu("walked shading showcase 32x32 1 spp", lambda d: showcase_scene((32, 32), d), 1)
    card_vs_cpu("walked materials 32x32 4 spp",
                lambda d: materials.build_materials_scene((32, 32)).build(device=d), 4)
  return counts


def _nvdb_writer():
  """`tests/nvdb_writer.py`, loaded by its path (as `_shading_showcase`)."""
  path = Path(__file__).resolve().parent / "tests" / "nvdb_writer.py"
  spec = importlib.util.spec_from_file_location("nvdb_writer", path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def cloud_scene_files(directory: Path, grid_file: str) -> str:
  """The Cornell scene files with a heterogeneous medium `cloud` read from
  `grid_file` (in `directory`), the camera and every material in it."""
  scene_file = assets.write_cornell_asset(str(directory))
  mtl = Path(scene_file).with_suffix(".mtl")
  text = mtl.read_text().replace("two_sided 1\n", "two_sided 1\next_medium cloud\n")
  head = (f"newmtl et::medium\nid cloud\nscattering 4.0 4.0 4.0\nvolume {grid_file}\n\n"
          "newmtl et::camera\norigin 0.0 1.0 3.82\ntarget 0.0 1.0 -6.18\nup 0.0 1.0 0.0\n"
          "viewport 640 640\nfov 39.597755335771296\nclip-near 0.1\nclip-far 100.0\n"
          "ext_medium cloud\n\n")
  mtl.write_text(head + text)
  return scene_file


def nvdb_phase(dev):
  """Bench config 4's cloud density written as a BLOSC .nvdb by the JAX-free
  writer of `tests/nvdb_writer.py`, read back (through the native blosc
  decoder) equal to the grid; the Cornell scene files with that grid as a
  medium rendered by `cli render` in a subprocess at NVDB_SIZE, NVDB_SPP
  spp and path length NVDB_PATH_LENGTH, by PT through K1 (no shadow ray reaches K2 in a medium); the same
  files with the grid as a `.vol` rendered by `cli.main` in this process;
  both gated and held to each other."""
  work = Path(_build.BUILD_DIR) / "nvdb"
  shutil.rmtree(work, ignore_errors=True)
  work.mkdir(parents=True)
  os.environ["ETX_TPU_CONFIG_DIR"] = str(work / "prefs")
  grid = volumetric._expected_grid()
  t0 = time.perf_counter()
  _nvdb_writer().write_dense(str(work / "cloud.nvdb"), grid, codec=2)
  back = nvdb.read_nvdb_density(str(work / "cloud.nvdb"))
  check(back is not None and np.array_equal(back, np.maximum(grid, 0.0)),
        "the BLOSC .nvdb cloud did not read back as its grid")
  shutil.copy(volumetric._cloud_vol_path(), work / "cloud.vol")
  say("nvdb", f"cloud {grid.shape} written as BLOSC .nvdb ({(work / 'cloud.nvdb').stat().st_size} "
      f"bytes) and read back equal in {time.perf_counter() - t0:.2f} s")
  size = f"{NVDB_SIZE[0]}x{NVDB_SIZE[1]}"
  images = {}
  for ext in ("nvdb", "vol"):
    scene_file = cloud_scene_files(work / ext, f"../cloud.{ext}")
    exr = work / f"{ext}.exr"
    args = ["render", scene_file, "-o", str(exr), "--size", size, "--spp", str(NVDB_SPP),
            "--max-path", str(NVDB_PATH_LENGTH)]
    t0 = time.perf_counter()
    if ext == "nvdb":
      proc = subprocess.run([sys.executable, "-m", "etx_tracer_tpu_torch.cli", *args],
                            cwd=str(Path(__file__).resolve().parent), capture_output=True,
                            text=True, timeout=600)
      check(proc.returncode == 0, f"cli render (.nvdb) exited {proc.returncode}:\n"
            f"{proc.stderr[-3000:]}")
      for line in proc.stderr.splitlines():
        say("nvdb", f"  {line}")
      found = re.search(r"trace kernel launches: (\{.*\})", proc.stderr)
      check(found is not None, "cli render (.nvdb) printed no launch counts")
      launched = json.loads(found.group(1))
      check(launched.get("brute_trace.intersect", 0) > 0
            and set(launched) <= {"brute_trace.intersect", "brute_trace.occluded"},
            f"cli render (.nvdb) launched {launched}, not K1")
    else:
      reset_counts()
      cli.main(args)
      launched = {k: c for k, c in read_counts().items() if c}
    seconds = time.perf_counter() - t0
    img = image_io.load_exr(str(exr))
    check(img.shape == (NVDB_SIZE[1], NVDB_SIZE[0], 3) and bool(np.isfinite(img).all())
          and float(img.min()) >= 0.0, f"cloud ({ext}): image shape {img.shape} or values")
    say("nvdb", f"cli render, the grid as .{ext}: {seconds:.3f} s "
        f"({'subprocess' if ext == 'nvdb' else 'in process'}), launches {launched}, image mean "
        f"{float(img.mean()):.6f}")
    images[ext] = img
  same_image("nvdb", "cloud .nvdb (cli render) vs .vol", images["nvdb"], images["vol"])


def native_phase(dev):
  """The native library: the compiler, the build, and what takes it. The
  bigscene BVH built natively and by numpy (K5-K8 on each tree, timed and
  held bit-equal to their plain walks on the native one); the OBJ scene
  files of the CLI parsed natively, frozen to the Python parse's tables; a
  PIZ EXR round trip (HALF and FLOAT). Fails if the library does not
  build."""
  gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60)
  say("native", f"{gxx.stdout.splitlines()[0] if gxx.returncode == 0 else 'no g++'}; zlib.h "
      f"{'present' if Path('/usr/include/zlib.h').exists() else 'missing'}")
  seconds = native.build()
  check(native.load() is not None, f"the native library did not load: {native.failure()}")
  say("native", f"library {native.library_path().name} (g++ {seconds:.2f} s, 0: built already)")

  b = bigscene.build_bigscene((64, 64))
  arrays, _ = b.arrays()
  check(b.bvh_builder == "native", f"bigscene's BVH was built by {b.bvh_builder}")
  v0, e1, e2 = (arrays[k] for k in ("tri_v0", "tri_e1", "tri_e2"))
  t0 = time.perf_counter()
  bvh_build.build_bvh(v0, e1, e2)
  t_native = time.perf_counter() - t0
  t0 = time.perf_counter()
  tree_np = bvh_build.build_bvh_numpy(v0, e1, e2)
  t_numpy = time.perf_counter() - t0
  trees = {"native": scene_types.bvh_from_arrays(bvh_build.kernel_tables(arrays), dev)}
  np_arrays = {**arrays, **{f"bvh.{k}": v for k, v in tree_np.items() if v is not None}}
  trees["numpy"] = scene_types.bvh_from_arrays(bvh_build.kernel_tables(np_arrays), dev)
  say("native", f"bigscene BVH: native {t_native:.3f} s, {trees['native'].node_table.shape[0]} "
      f"nodes, {trees['native'].fat_table.shape[0]} fat rows; numpy {t_numpy:.3f} s, "
      f"{trees['numpy'].node_table.shape[0]} nodes, {trees['numpy'].fat_table.shape[0]} fat rows")
  tris = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (v0, e1, e2)]
  rays = test_rays(np.random.default_rng(20261019), *tris, RAYS, dev, inside=ROOM)
  for name in ("intersect_bvh_fat", "occluded_bvh_fat", "intersect_bvh", "occluded_bvh"):
    ms = {}
    for label, tree in trees.items():
      if name in ("intersect_bvh", "occluded_bvh"):
        tree = scene_types.without_fat_rows(tree)
      geometry = (tris, tree)
      if label == "native":
        compare(name, geometry, rays, None)
      ms[label] = kernel_ms(lambda g=geometry: kernel_call(name, g)(*rays), KERNELS[name][2], 20)
    say("native", f"{name} on 2^18 bigscene rays: native tree {ms['native']:.4f} ms, numpy tree "
        f"{ms['numpy']:.4f} ms a launch (bit-equal to the plain walk on the native tree)")

  work = Path(_build.BUILD_DIR) / "native"
  shutil.rmtree(work, ignore_errors=True)
  scene_file = assets.write_cornell_asset(str(work / "scene"))
  obj = str(Path(scene_file).with_suffix(".obj"))
  check(native.parse_obj_native(obj) is not None, "the native OBJ parse failed")
  parsed, _ = json_scene.load_scene(scene_file).arrays()
  saved = native.parse_obj_native
  native.parse_obj_native = lambda *a, **k: None
  try:
    python, _ = json_scene.load_scene(scene_file).arrays()
  finally:
    native.parse_obj_native = saved
  check(set(parsed) == set(python) and all(np.array_equal(np.asarray(parsed[k]),
                                                          np.asarray(python[k])) for k in parsed),
        "the native OBJ parse froze other tables than the Python parse")
  say("native", f"the CLI's Cornell scene files parsed natively: {parsed['tri_v0'].shape[0]} "
      "triangles, the Python parse's tables")

  img = np.random.default_rng(3).uniform(0.0, 4.0, (64, 96, 3)).astype(np.float32)
  img[:, :48] = 0.5   # a flat half, so PIZ blocks compress
  for half in (False, True):
    path = work / f"piz{int(half)}.exr"
    image_io.save_exr(str(path), img, compression="piz", half=half)
    raw = path.read_bytes()
    tag = b"compression\x00compression\x00"
    back = image_io.load_exr(str(path))
    want = img.astype(np.float16).astype(np.float32) if half else img
    check(raw[raw.index(tag) + len(tag) + 4] == 4 and np.array_equal(back, want[::-1]),
          f"PIZ EXR round trip (half={half})")
  say("native", "PIZ EXR round trip, FLOAT and HALF: equal")


def denoise_phase(dev):
  """`benchmarks/denoise_eval` on the card with its ground truth cut to
  DENOISE_GT_SPP spp: every MSE and SSIM finite, the denoised images closer
  to the ground truth than the noisy ones away from the emitter edges."""
  t0 = time.perf_counter()
  out = denoise_eval.run(dev, gt_spp=DENOISE_GT_SPP)
  for row in out:
    check(all(np.isfinite(r["mse"]) and 0.0 < r["ssim"] <= 1.0 for r in row["per_depth"]),
          f"denoise_eval {row['spp']} spp: {row}")
    check(row["best_mse_reduction_x_excl_top5pct"] > 1.0,
          f"denoise_eval {row['spp']} spp: no reduction of the interior MSE")
  say("denoise", f"denoise_eval ({DENOISE_GT_SPP}-spp ground truth) in "
      f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
          f"{r['spp']} spp MSE {r['mse_noisy']:.3e} -> best interior reduction "
          f"{r['best_mse_reduction_x_excl_top5pct']:.2f}x" for r in out))



def main() -> int:
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
    return 2
  dev = torch.device("cuda")
  kind = torch.cuda.get_device_name(0)
  # the volumetric scene's `.vol` cloud goes to a cache inside the checkout
  os.environ["XDG_CACHE_HOME"] = str(Path(_build.BUILD_DIR) / "cache")

  smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, check=True, timeout=60)
  card_line = smi.stdout.strip().splitlines()[0]
  say("device", f"{card_line} ({kind}, torch {torch.__version__}, CUDA {torch.version.cuda})")

  t0 = time.perf_counter()
  built = _build.build_all()
  say("build", f"{len(built)} source(s) built in {time.perf_counter() - t0:.2f} s")
  for name, (seconds, log) in built.items():
    usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    say("build", f"{name}: nvcc {seconds:.2f} s; " + " | ".join(usage))

  rng = np.random.default_rng(20261017)
  cornell_512 = cornell_scene((512, 512), 1023, dev)
  materials_512 = materials_scene((512, 512), dev)
  bigscene_512 = bigscene_scene((512, 512), dev)
  caustics_scene = staged("caustics", caustics.build_caustics_scene((512, 512)), dev)[0]
  cornell_geo = (list(cornell_512[0][:3]), None)
  mat_geo = (list(materials_512[0][:3]), None)
  big_geo = (list(bigscene_512[0][:3]), bigscene_512[0].bvh)
  caustics_geo = (list(caustics_scene[:3]), None)
  # cases: (label, geometry, origin box, rays); the dispatch thresholds are
  # 128 (K1/K2) and 4096 (K3/K4) triangles, the kernels take any count
  soup128 = ("soup128", (tri_soup(rng, 128, dev), None), None, RAYS)
  soup4096 = ("soup4096", (tri_soup(rng, 4096, dev), None), None, RAYS)
  soup129 = ("soup129", (tri_soup(rng, 129, dev), None), None, RAYS)
  soup4097 = ("soup4097", (tri_soup(rng, 4097, dev), None), None, RAYS)
  small = [("cornell", cornell_geo, None, RAYS), soup128,
           ("materials", mat_geo, ROOM, FEW_RAYS), ("bigscene", big_geo, ROOM, FEW_RAYS)]
  pair_tile = [("materials", mat_geo, ROOM, RAYS), soup4096, soup4097, soup129,
               ("cornell", cornell_geo, None, RAYS), ("bigscene", big_geo, ROOM, RAYS)]
  woop = [("materials", mat_geo, ROOM, RAYS), ("caustics", caustics_geo, ROOM, RAYS),
          ("bigscene", big_geo, ROOM, RAYS), soup4096, soup129]
  soup = soup_tree(rng, 5000, dev)
  comb = comb_tree(rng, 61, dev)
  bvh_fat = [("bigscene", big_geo, ROOM, RAYS), ("soup5000", soup, None, RAYS),
             ("comb61", comb, None, FEW_RAYS)]
  bvh_node = [(label, (tris, scene_types.without_fat_rows(bvh)), box, num_r)
              for label, (tris, bvh), box, num_r in bvh_fat]
  # K1, K3 and K9a timed also at bigscene's 15,396 triangles, at the micro
  # groups' ray counts (K1: `trace`, 2^16; K3 and K9a: `trace_brute`, 2^18)
  big_k1 = ("bigscene", big_geo, ROOM, 1 << 16)
  results = {
      "intersect": kernel_phase("intersect", dev, rng, small, [small[0], big_k1]),
      "occluded": kernel_phase("occluded", dev, rng, small, small[:1]),
  }
  # a generator of its own, so the later phases draw the rays they drew before
  narrow_rng = np.random.default_rng(20261018)
  for name in ("intersect", "occluded"):
    narrow_phase(name, cornell_geo, dev, narrow_rng)
  results |= {
      "intersect_brute2": kernel_phase("intersect_brute2", dev, rng, pair_tile,
                                       [pair_tile[0], pair_tile[-1]]),
      "occluded_brute2": kernel_phase("occluded_brute2", dev, rng, pair_tile, pair_tile[:1]),
      "intersect_bvh_fat": kernel_phase("intersect_bvh_fat", dev, rng, bvh_fat, bvh_fat[:1]),
      "occluded_bvh_fat": kernel_phase("occluded_bvh_fat", dev, rng, bvh_fat, bvh_fat[:1]),
      "intersect_bvh": kernel_phase("intersect_bvh", dev, rng, bvh_node, bvh_node[:1]),
      "occluded_bvh": kernel_phase("occluded_bvh", dev, rng, bvh_node, bvh_node[:1]),
      "intersect_woop": kernel_phase("intersect_woop", dev, rng, woop, [woop[0], woop[2]]),
      "occluded_woop": kernel_phase("occluded_woop", dev, rng, woop, woop[:1]),
  }
  for name in ("intersect_woop", "occluded_woop"):
    narrow_phase(name, mat_geo, dev, narrow_rng, WOOP_NARROW, ROOM)
  woop_matmul_note(dev)

  counts = main_path_cornell(*cornell_512, dev)
  profile_step_mix("cornell 512x512", *cornell_512, dev)
  captured_phase("cornell", ("intersect", "occluded"), *cornell_512, dev)
  counts_mat = main_path_materials(*materials_512, dev)
  profile_step_mix("materials 512x512", *materials_512, dev)
  captured_phase("materials", ("intersect_brute2", "occluded_brute2"), *materials_512, dev)
  counts_big, img_big = main_path_bigscene(*bigscene_512, dev)
  profile_step_mix("bigscene 512x512", *bigscene_512, dev)
  captured_phase("bigscene", ("intersect_bvh_fat", "occluded_bvh_fat"), *bigscene_512, dev)
  # the same scene and seeds without the fat rows: K7/K8 on a full-width path
  nofat_512 = (bigscene_512[0]._replace(bvh=scene_types.without_fat_rows(bigscene_512[0].bvh)),
               bigscene_512[1])
  counts_node, img_node = main_path_bigscene(*nofat_512, dev)
  # the two walks may keep other triangles of an exact tie
  same_image("main", "bigscene without fat rows vs with", img_node, img_big)
  profile_step_mix("bigscene 512x512 without fat rows", *nofat_512, dev)
  captured_phase("bigscene without fat rows", ("intersect_bvh", "occluded_bvh"), *nofat_512, dev)
  volumetric_384 = volumetric_scene(VOLUMETRIC_SIZE, dev)
  counts_vol = main_path_volumetric(*volumetric_384, dev)
  profile_step_mix("volumetric 384x384", *volumetric_384, dev)
  segment = captured_segment_phase(*volumetric_384, dev)
  subsurface_384 = subsurface_scene(VOLUMETRIC_SIZE, dev)
  counts_sss = main_path_subsurface(*subsurface_384, dev)
  profile_step_mix("subsurface 384x384", *subsurface_384, dev)
  caustics_256 = staged("caustics", caustics.build_caustics_scene(VCM_SIZE), dev)
  counts_cvcm = main_path_caustics(*caustics_256, dev)
  rows_cvcm = captured_vcm_phase("caustics VCM", *caustics_256, vcm.VCMOptions(),
                                 ("intersect_brute2", "occluded_brute2"), dev)
  del caustics_256
  volumetric_256 = volumetric_scene(VCM_SIZE, dev)
  counts_vbdpt = main_path_volumetric_bdpt(*volumetric_256, dev)
  rows_vbdpt = captured_vcm_phase("volumetric BDPT", *volumetric_256, vcm.bdpt_options(),
                                  ("intersect", "intersect"), dev)
  del volumetric_256
  atmosphere_512, atmosphere_builder, counts_atm = main_path_atmosphere(dev)
  profile_step_mix("atmosphere 512x512", *atmosphere_512, dev)
  rows_atm = captured_atmosphere(*atmosphere_512, dev)
  del atmosphere_512
  showcase_512, counts_show = main_path_showcase(dev)
  captured_phase("shading showcase", ("intersect_brute2", "occluded_brute2"), *showcase_512, dev)
  del showcase_512
  counts_cli, scene_file = cli_phase(dev)
  counts_devices = devices_phase(scene_file)
  counts_viewer = viewer_phase(Path(scene_file).parent.parent)
  counts_sharded = sharded_cornell_phase(dev)
  counts_sharded_vcm = sharded_caustics_phase(dev)
  validate_phase(dev)
  # the staged sky and sun serve the 32x32 render too
  atmosphere_builder.film_size = (32, 32)
  end_to_end(atmosphere_builder)
  counts_micro = micro_phase(dev)
  counts_walk = walk_phase(dev)
  nvdb_phase(dev)
  native_phase(dev)
  denoise_phase(dev)

  launches = {"intersect": counts["intersect"], "occluded": counts["occluded"],
              "intersect_brute2": counts_mat["intersect_brute2"],
              "occluded_brute2": counts_mat["occluded_brute2"],
              "intersect_bvh_fat": counts_big["intersect_bvh_fat"],
              "occluded_bvh_fat": counts_big["occluded_bvh_fat"],
              "intersect_bvh": counts_node["intersect_bvh"],
              "occluded_bvh": counts_node["occluded_bvh"],
              "intersect_woop": counts_micro["intersect_woop"],
              "occluded_woop": counts_micro["occluded_woop"]}
  kernels = []
  for name, r in results.items():
    _, _, _, replaces, source = KERNELS[name]
    kernels.append({
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None})
  # K1/K2 on the media slice's paths, beside the Cornell path's numbers
  say("kernels", f"K1/K2 launches on the volumetric path {counts_vol['intersect']} / "
      f"{counts_vol['occluded']}, on the subsurface path {counts_sss['intersect']} / "
      f"{counts_sss['occluded']}; K1 on the volumetric bounce-2 transmittance segment: {segment}")
  say("kernels", "K1/K2/K3/K4 launches on the caustics VCM path "
      + " / ".join(str(counts_cvcm[k]) for k in ("intersect", "occluded", "intersect_brute2",
                                                 "occluded_brute2"))
      + ", on the volumetric BDPT path "
      + " / ".join(str(counts_vbdpt[k]) for k in ("intersect", "occluded", "intersect_brute2",
                                                  "occluded_brute2"))
      + f" (iterations 0-{VCM_TIMED} each); on their camera step {VCM_CAPTURE_STEP}: caustics "
      f"VCM {rows_cvcm}, volumetric BDPT {rows_vbdpt}")
  say("kernels", f"K1/K2 launches on the atmosphere path {counts_atm['intersect']} / "
      f"{counts_atm['occluded']} ({ATMOSPHERE_ITERATIONS} warm + {ATMOSPHERE_REPS} x "
      f"{ATMOSPHERE_ITERATIONS} spp); on its bounce {CAPTURE_BOUNCE}: {rows_atm}")
  say("kernels", "K1/K2 launches on the CLI paths (the Cornell scene files, 640x640): "
      + ", ".join(f"{run} {c['intersect']} / {c['occluded']}" for run, c in counts_cli.items()))
  say("kernels", "K1/K2 launches on the sharding slice's paths (all ranks): "
      + ", ".join(f"cornell {run} {c['intersect']} / {c['occluded']}"
                  for run, c in counts_sharded.items())
      + f", --devices 2 {counts_devices['intersect']} / {counts_devices['occluded']}, the viewer "
      f"{counts_viewer['intersect']} / {counts_viewer['occluded']}; K3/K4 on the sharded "
      f"caustics VCM {counts_sharded_vcm['intersect']} / {counts_sharded_vcm['occluded']}")
  say("kernels", f"K3/K4 launches on the shading showcase path "
      f"{counts_show['intersect_brute2']} / {counts_show['occluded_brute2']} "
      f"({SHOWCASE_ITERATIONS} warm + {SHOWCASE_REPS} x {SHOWCASE_ITERATIONS} spp), under the "
      f"walks {counts_walk['intersect_brute2']} / {counts_walk['occluded_brute2']} "
      f"({WALK_ITERATIONS} warm + {WALK_ITERATIONS} spp)")
  print(card_line, flush=True)
  print(json.dumps({"kernels": kernels}), flush=True)
  # one card: the run uses cuda:0 and nothing else
  print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": 1}}),
        flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
