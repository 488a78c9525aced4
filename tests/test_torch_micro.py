"""The port's trace micro-benchmark entry against the JAX package's (CPU).

`etx_tracer_tpu_torch/benchmarks/micro.py` ports the four trace groups of
the JAX package's `benchmarks/micro.py`. On the CPU (`--device cpu`) it runs
the kernels' plain versions at a size the caller passes. Here:

- its bench scenes (materials, caustics, bigscene) and their bounding
  spheres equal the JAX package's, field by field, and its ray sets are
  bit-equal to the JAX file's `_rays`;
- `trace_brute` at 2^10 rays gives the hits the JAX group's kernels give,
  the pair-tile K3/K4 (`_kernel_brute2`, `_kernel_brute2_anyhit`) and the
  Woop K9a/K9b (`_kernel_woop`, `_kernel_woop_anyhit`), run in interpret
  mode on the JAX scenes and the JAX file's rays, at the tolerances of
  tests/test_torch_trace.py and tests/test_torch_woop.py;
- `trace`, `trace_sorted` and `trace_oracle` give one answer for each ray,
  whatever the kernel (K5, K1) and whatever the ray order.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import micro as jmicro
from benchmarks import scenes as jscenes
from etx_tracer_tpu import native as jnative
from etx_tracer_tpu.ops import trace as jtrace
from etx_tracer_tpu_torch.benchmarks import micro
from etx_tracer_tpu_torch.ops import bvh_trace, woop_trace
from etx_tracer_tpu_torch.ops import trace as ptrace
from etx_tracer_tpu_torch.scene import caustics
from etx_tracer_tpu_torch.scene import types as ptypes
from tests.test_torch_trace import T_ATOL, T_RTOL, _interpret_brute2, _tris
from tests.test_torch_woop import _interpret_woop, _ties_and_grazing
from tests.torch_pins import port_numpy_tree  # noqa: F401  (autouse)

torch.set_num_threads(1)

RAYS = 1 << 10
SCENES = ("materials", "caustics", "bigscene")


@pytest.fixture(scope="module")
def jax_scenes():
  """The JAX package's bench scenes as its micro file builds them (256 x
  256), the trees by its numpy builder."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(jnative, "build_bvh_native", lambda *a, **k: None)
    return {name: getattr(jscenes, name)(micro.FILM).build()[0] for name in SCENES}


@pytest.fixture(scope="module")
def brute_lines():
  """`python -m etx_tracer_tpu_torch.benchmarks.micro trace_brute --device
  cpu` at 2^10 rays, one step per chain."""
  lines = micro.main(["trace_brute", "--device", "cpu", "--rays", str(RAYS)])
  return {line.label: line for line in lines}


def test_caustics_tables_equal_jax(jax_scenes):
  jscene = jax_scenes["caustics"]
  arrays, config = caustics.build_caustics_scene(micro.FILM).arrays()
  assert arrays["tri_v0"].shape == (caustics.NUM_TRIANGLES, 3)
  for name, got in arrays.items():
    if name.startswith("bvh."):
      continue   # the JAX package may build its tree natively; tests/test_torch_bigscene.py
    want = jscene
    for part in name.split("."):
      want = getattr(want, part)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, name
    np.testing.assert_array_equal(got, want, err_msg=name)
  jconfig = jscenes.caustics(micro.FILM).build()[1]
  for f in dataclasses.fields(ptypes.SceneConfig):
    assert getattr(config, f.name) == getattr(jconfig, f.name), f.name


@pytest.mark.parametrize("name", SCENES)
def test_bench_scenes_bounding_spheres_equal_jax(jax_scenes, name):
  port = micro.scene(name, "cpu")
  jscene = jax_scenes[name]
  for field in ("bsphere_center", "bsphere_radius"):
    got, want = getattr(port, field).numpy(), np.asarray(getattr(jscene, field))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
  for field in ("tri_v0", "tri_e1", "tri_e2"):
    np.testing.assert_array_equal(getattr(port, field).numpy(), np.asarray(getattr(jscene, field)))


@pytest.mark.parametrize("kind", ["primary", "bounce", "random"])
def test_micro_rays_equal_jax(jax_scenes, kind):
  for name in ("materials", "bigscene"):
    want = jmicro._rays(jax_scenes[name], 3000, kind)
    got = micro._rays(micro.scene(name, "cpu"), 3000, kind, torch.device("cpu"))
    for g, w in zip(got, want):
      assert g.dtype == torch.float32
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", SCENES)
def test_micro_trace_brute_gives_the_jax_groups_hits(jax_scenes, brute_lines, name):
  jscene = jax_scenes[name]
  rays = [np.asarray(x) for x in jmicro._rays(jscene, RAYS, "random")]
  tris = [np.asarray(getattr(jscene, f)) for f in ("tri_v0", "tri_e1", "tri_e2")]
  num_t = tris[0].shape[0]
  tie, grazing = _ties_and_grazing(*tris, *rays, np.ones(num_t, bool))
  (b_t, b_tri, _, _), b_occ = _interpret_brute2(*tris, *rays, None)
  (w_t, w_tri, _, _), w_occ = _interpret_woop(*tris, *rays, None)
  for label, (rt, rtri, rocc) in (("brute2", (b_t, b_tri, b_occ)), ("woop", (w_t, w_tri, w_occ))):
    hit = brute_lines[f"{name} {label} closest"].result
    occ = brute_lines[f"{name} {label} anyhit"].result.numpy()
    assert brute_lines[f"{name} {label} closest"].tris == num_t
    gtri = hit.tri.numpy()
    assert not ((gtri != rtri) & ~tie & ~grazing).any(), label
    assert not ((occ != rocc) & ~grazing).any(), label
    assert (gtri == rtri).mean() > 0.97, label
    f = (rtri >= 0) & (gtri == rtri)
    assert f.mean() > 0.2, label   # origins fill the bounding sphere
    np.testing.assert_allclose(hit.t.numpy()[f], rt[f], rtol=T_RTOL, atol=T_ATOL, err_msg=label)
    np.testing.assert_array_equal(occ, gtri >= 0)


def test_micro_trace_group_k5_and_k1_agree():
  """K5 and K1 share one triangle test, so wherever no two hits tie they
  give the same triangle at the same t, bit for bit."""
  lines = {line.label: line for line in micro.run("trace", "cpu", 128)}
  for kind in ("primary", "bounce", "random"):
    fat, brute = lines[f"fat {kind}"].result, lines[f"brute {kind}"].result
    assert lines[f"fat {kind}"].tris == 15396
    # equal t everywhere: where the triangles differ, two hits tie exactly
    # (the room's coplanar quads), and the walks keep different ones
    np.testing.assert_array_equal(fat.t.numpy(), brute.t.numpy())
    assert (fat.tri == brute.tri).float().mean().item() > 0.9, kind
    assert fat.found.float().mean().item() > 0.2


def test_micro_sorted_and_oracle_orders_give_the_unsorted_hits():
  scn = micro.scene("bigscene", "cpu")
  dev = torch.device("cpu")
  sorted_lines = {line.label: line for line in micro.run("trace_sorted", "cpu", 256)}
  oracle_lines = {line.label: line for line in micro.run("trace_oracle", "cpu", 256)}
  for kind in ("bounce", "random"):
    o, d, tmin, tmax = micro._rays(scn, 256, kind, dev)
    want = bvh_trace.intersect_fat(scn.bvh, o, d, tmin, tmax)
    got = sorted_lines[f"fat+sort {kind}"].result
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for name, key in micro.oracle_keys(scn.bvh, o, d, want):
      perm = torch.argsort(key, stable=True)
      got = oracle_lines[f"oracle[{name}] {kind}"].result
      assert all(torch.equal(a, b[perm]) for a, b in zip(got, want))
      if name == "tri":
        assert torch.equal(got.tri[got.tri >= 0], got.tri[got.tri >= 0].sort().values)


def test_oracle_position_keys_equal_jax():
  scn = micro.scene("bigscene", "cpu")
  o, d, t_min, t_max = micro._rays(scn, 2048, "bounce", torch.device("cpu"))
  hit = bvh_trace.intersect_fat(scn.bvh, o, d, t_min, t_max)
  root_min, root_max = (x.numpy() for x in ptrace._root_box(scn.bvh))
  # the JAX file's expression for the position key, on the same hits
  hp = jnp.asarray(o.numpy()) + jnp.asarray(d.numpy()) * jnp.where(
      jnp.isfinite(jnp.asarray(hit.t.numpy())), jnp.asarray(hit.t.numpy()), 0.0)[:, None]
  root_ext = jnp.maximum(jnp.asarray(root_max) - jnp.asarray(root_min), 1e-6)
  q = jnp.clip((hp - jnp.asarray(root_min)) / root_ext, 0.0, 1.0)
  cell = (q * 511.0).astype(jnp.uint32)
  want = (jtrace._spread3(cell[:, 0]) | (jtrace._spread3(cell[:, 1]) << 1)
          | (jtrace._spread3(cell[:, 2]) << 2)).astype(jnp.int32)
  keys = dict(micro.oracle_keys(scn.bvh, o, d, hit))
  np.testing.assert_array_equal(keys["pos"].numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("group", ["sort", "mxu", "dispatch", "step"])
def test_micro_later_groups_raise(group):
  """The groups that were a later slice (and raised) now run: on the CPU at
  64 rows or lanes, every line a positive time."""
  lines = micro.main([group, "--device", "cpu", "--rays", "64"])
  assert lines and all(x.group == group and x.seconds > 0.0 for x in lines)
  labels = {x.label for x in lines}
  want = {"sort": "cumsum n=64", "mxu": "matmul (64,16)@(16,64)",
          "dispatch": "sample all-classes", "step": "pt_step full"}[group]
  assert want in labels, labels


def test_micro_entry_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    micro.main(["trace_brute", "--rays", "8"])
  with pytest.raises(ValueError, match="unknown micro group"):
    micro.run("trace_bvh", "cpu")


def test_micro_chain_step_is_one_wrapper_call_on_the_unmoved_rays():
  """The chain's first step is one call of the wrapper on the unmoved rays,
  and its data dependency leaves O(1) origins unchanged."""
  rng = np.random.default_rng(51)
  v0, e1, e2 = (torch.from_numpy(x) for x in _tris(rng, 200))
  o = torch.from_numpy(rng.uniform(-1, 1, (256, 3)).astype(np.float32))
  d = torch.nn.functional.normalize(torch.from_numpy(rng.normal(size=(256, 3)).astype(np.float32)))
  tmin, tmax = torch.full((256,), 1e-4), torch.full((256,), 1e30)
  fn = micro._dense(woop_trace.intersect, types.SimpleNamespace(tri_v0=v0, tri_e1=e1, tri_e2=e2))
  step, state = micro._trace_chain(fn, o, d, tmin, tmax)
  (o2, acc), hit = step(state)
  assert torch.equal(o2, o)
  ref = woop_trace.intersect(v0, e1, e2, o, d, tmin, tmax)
  assert all(torch.equal(a, b) for a, b in zip(hit, ref))
  assert acc.item() == pytest.approx(float(torch.where(ref.found, ref.t, 0.0).sum()))
