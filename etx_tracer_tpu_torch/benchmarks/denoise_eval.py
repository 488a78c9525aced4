"""The denoiser's quality against a converged render.

    python -m etx_tracer_tpu_torch.benchmarks.denoise_eval [--device cpu]
        [--size 128] [--gt-spp 4096]

The counterpart of the JAX package's `benchmarks/denoise_eval.py`, with its
protocol: the diffuse Cornell box at 128 x 128 and path length 8; a
4,096-spp ground truth through the pooled renderer (`render_samples_static`,
a 2^16-lane pool); 4 and 32 spp with the normal and albedo AOVs
(`path_tracing.render`), each denoised by the a-trous filter
(`render/denoiser.denoise_film`) at 1, 2, 3 and 5 levels. It prints one
JSON object per sample count, with the JAX file's keys: the MSE of the noisy
and of each denoised image against the ground truth, over the whole image
and without the pixels of the noisy image's top 5% of errors (the emitter
edges, which no edge-preserving filter fixes at low spp), the median, the
SSIM (`ssim`: 7 x 7 uniform windows, numpy) and the best reduction of the
MSE. The entry runs on the CUDA card unless given `--device cpu`;
`--size` and `--gt-spp` cut the protocol to size.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from etx_tracer_tpu_torch import resolve_device
from etx_tracer_tpu_torch.models import path_tracing
from etx_tracer_tpu_torch.render import denoiser
from etx_tracer_tpu_torch.render import film as film_mod
from etx_tracer_tpu_torch.scene import cornell

SIZE = 128
GT_SPP = 4096
GT_POOL = 1 << 16
SPPS = (4, 32)
LEVELS = (1, 2, 3, 5)


def ssim(a, b, data_range=None):
  """Mean SSIM over channels, 7x7 uniform window (numpy, no deps)."""
  if data_range is None:
    data_range = max(float(a.max()), float(b.max()), 1e-6)
  c1 = (0.01 * data_range) ** 2
  c2 = (0.03 * data_range) ** 2

  def win_mean(x):
    k = 7
    pad = k // 2
    xp = np.pad(x, ((pad, pad), (pad, pad), (0, 0)), mode="reflect")
    out = np.zeros_like(x)
    for dy in range(k):
      for dx in range(k):
        out += xp[dy:dy + x.shape[0], dx:dx + x.shape[1]]
    return out / (k * k)

  mu_a = win_mean(a)
  mu_b = win_mean(b)
  va = win_mean(a * a) - mu_a ** 2
  vb = win_mean(b * b) - mu_b ** 2
  cov = win_mean(a * b) - mu_a * mu_b
  s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
      (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))
  return float(s.mean())


def run(device=None, size: int = SIZE, gt_spp: int = GT_SPP, spps=SPPS, levels=LEVELS,
        pool_size: int = GT_POOL) -> list:
  """Run the protocol on `device` (default: the CUDA card); prints and
  returns one dict per sample count."""
  dev = resolve_device(device)
  scene, config = cornell.build_cornell_box(film_size=(size, size), diffuse_only=True,
                                            max_path_length=8).build(device=dev)
  sums, _ = path_tracing.render_samples_static(scene, config, 0, gt_spp,
                                               pool_size=min(pool_size, size * size * gt_spp),
                                               device=dev)
  gt = path_tracing.finalize_film(sums, gt_spp, size).camera.cpu().numpy()

  results = []
  for spp in spps:
    fs = path_tracing.render(scene, config, iterations=spp, device=dev)
    noisy = film_mod.result_image(fs).cpu().numpy()
    e_noisy = ((noisy - gt) ** 2).mean(-1)
    # the image-mean MSE is dominated by the emitter edges' partially
    # covered pixels: report the interior too
    thr = np.percentile(e_noisy, 95)
    interior = e_noisy < thr
    rows = []
    for its in levels:
      den = denoiser.denoise_film(fs, iterations=its).cpu().numpy()
      e_den = ((den - gt) ** 2).mean(-1)
      rows.append((its, float(e_den.mean()), ssim(den, gt), float(e_den[interior].mean()),
                   float(np.percentile(e_den, 50))))
    mse_noisy = float(e_noisy.mean())
    best = min(rows, key=lambda r: r[3])
    out = {
        "spp": spp,
        "mse_noisy": mse_noisy,
        "mse_noisy_excl_top5pct": float(e_noisy[interior].mean()),
        "p50_noisy": float(np.percentile(e_noisy, 50)),
        "ssim_noisy": ssim(noisy, gt),
        "per_depth": [{"atrous_levels": r[0], "mse": r[1], "ssim": r[2],
                       "mse_excl_top5pct": r[3], "p50": r[4]} for r in rows],
        "best_mse_reduction_x_overall": mse_noisy / max(best[1], 1e-12),
        "best_mse_reduction_x_excl_top5pct": float(e_noisy[interior].mean()) / max(best[3], 1e-12),
        "oidn_class_published_mse_reduction_x": "10-20 (typical, for context)",
    }
    print(json.dumps(out, indent=2), flush=True)
    results.append(out)
  return results


def main(argv=None):
  p = argparse.ArgumentParser(prog="python -m etx_tracer_tpu_torch.benchmarks.denoise_eval",
                              description=__doc__.splitlines()[0])
  p.add_argument("--device", default=None, help="cuda (default) or cpu")
  p.add_argument("--size", type=int, default=SIZE, help="film side (default 128)")
  p.add_argument("--gt-spp", type=int, default=GT_SPP, help="ground-truth spp (default 4096)")
  args = p.parse_args(argv)
  return run(args.device, args.size, args.gt_spp)


if __name__ == "__main__":
  main()
