"""The quality harness: JAX package vs PyTorch port on the CPU.

Held: the golden scenes (static, yawed and dynamic) within 1e-5 of the JAX
package's arrays with the same dynamic masks; pair and clip
photo-consistency on ground-truth and perturbed depth within 1e-5 (with and
without eval masks); prune_static_flag and the stamp_disks binding give
flags identical to the JAX package's on one constraint set; the port's own
gates at tiny=True meet the thresholds tests/test_quality.py asserts for
the JAX gates; and (marked slow: the JAX side's compiles take about two
minutes) each tiny gate value within 0.02 of the JAX package's, the JAX
gates run in a subprocess as tests/test_quality.py runs them.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu import native as jnative
from robust_cvd_tpu import quality as jq
from robust_cvd_tpu.solver import constraints as jC
from robust_cvd_tpu_torch import native as tnative
from robust_cvd_tpu_torch import quality as tq
from robust_cvd_tpu_torch.solver import constraints as tC
from torch_pkg_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE = (48, 64)


def _np(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("yaw", [0.0, 0.02])
def test_golden_scene(yaw):
    j = jq.golden_scene(num_frames=6, shape=SHAPE, yaw_per_frame=yaw)
    t = tq.golden_scene(num_frames=6, shape=SHAPE, yaw_per_frame=yaw)
    for name in ("images", "depth", "extrinsics", "intrinsics"):
        np.testing.assert_allclose(_np(getattr(t, name)), _np(getattr(j, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert t.pairs == j.pairs


def test_golden_scene_dynamic():
    j = jq.golden_scene_dynamic(num_frames=6, shape=SHAPE)
    t = tq.golden_scene_dynamic(num_frames=6, shape=SHAPE)
    np.testing.assert_array_equal(_np(t.static_mask), _np(j.static_mask))
    for name in ("images", "depth", "extrinsics", "intrinsics"):
        np.testing.assert_allclose(_np(getattr(t, name)), _np(getattr(j, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert t.pairs == j.pairs


@pytest.mark.parametrize("perturb", [1.0, 1.2])
def test_photo_consistency(perturb):
    j = jq.golden_scene_dynamic(num_frames=6, shape=SHAPE)
    t = tq.golden_scene_dynamic(num_frames=6, shape=SHAPE)
    rng = np.random.default_rng(1)
    scale = (perturb * rng.uniform(0.9, 1.1, (6, 1, 1))).astype(np.float32)
    jd, td = j.depth * jnp.asarray(scale), t.depth * torch.from_numpy(scale)
    masks = rng.uniform(0, 1, (len(j.pairs),) + SHAPE).astype(np.float32)
    for m_j, m_t in ((None, None), (jnp.asarray(masks), torch.from_numpy(masks))):
        jr = jq.clip_photo_consistency(j.images, jd, j.extrinsics, j.intrinsics, j.pairs, m_j)
        tr = tq.clip_photo_consistency(t.images, td, t.extrinsics, t.intrinsics, t.pairs, m_t)
        np.testing.assert_allclose([float(v) for v in tr], [float(v) for v in jr],
                                   rtol=1e-5, atol=1e-7)
    a, b = j.pairs[3]
    jp = jq.pair_photo_consistency(j.images[a], j.images[b], jd[a], j.extrinsics[a],
                                   j.extrinsics[b], j.intrinsics[a], j.intrinsics[b])
    tp = tq.pair_photo_consistency(t.images[a], t.images[b], td[a], t.extrinsics[a],
                                   t.extrinsics[b], t.intrinsics[a], t.intrinsics[b])
    np.testing.assert_allclose([float(v) for v in tp], [float(v) for v in jp],
                               rtol=1e-5, atol=1e-7)
    if perturb == 1.0:
        return
    # on the static pixels the ground truth scores near zero, the perturbed
    # depth far worse
    masks = tq._static_pair_masks(t)
    gt = tq.clip_photo_consistency(t.images, t.depth, t.extrinsics, t.intrinsics, t.pairs, masks)
    bad = tq.clip_photo_consistency(t.images, td, t.extrinsics, t.intrinsics, t.pairs, masks)
    assert float(gt.l1) < 5e-3 and float(bad.l1) > 5 * max(float(gt.l1), 1e-4)


def test_stamp_disks_binding():
    rng = np.random.default_rng(2)
    xs = rng.integers(-3, 70, 40).astype(np.int32)
    ys = rng.integers(-3, 50, 40).astype(np.int32)
    for radius in (0, 1, 4):
        got = tnative.stamp_disks(xs, ys, 64, 48, radius)
        assert got.dtype == bool and got.shape == (48, 64)
        np.testing.assert_array_equal(got, jnative.stamp_disks(xs, ys, 64, 48, radius))
    assert not tnative.stamp_disks(xs[:0], ys[:0], 64, 48, 4).any()


def test_prune_static_flag():
    n, (h, w) = 5, SHAPE
    pair_keys = [(i, i + 1) for i in range(n - 1)] + [(i, i + 2) for i in range(n - 2)]
    triplet_keys = list(range(1, n - 1))

    def build(mod):
        r = np.random.default_rng(4)
        pairs = {}
        for k in pair_keys:
            c = int(r.integers(20, 40))
            pairs[k] = mod.PairConstraints(
                loc0=r.uniform(0, [1, h / w], (c, 2)).astype(np.float32),
                loc1=r.uniform(0, [1, h / w], (c, 2)).astype(np.float32),
                is_static=r.uniform(0, 1, c) > 0.1,
            )
        triplets = {
            k: mod.TripletConstraints(
                loc=r.uniform(0, [1, h / w], (30, 3, 2)).astype(np.float32),
                is_static=np.ones(30, bool),
            )
            for k in triplet_keys
        }
        return pairs, triplets

    jp, jt = build(jC)
    tp, tt = build(tC)
    jC.prune_static_flag(n, pair_keys, jp, triplet_keys, jt, SHAPE, 4)
    tC.prune_static_flag(n, pair_keys, tp, triplet_keys, tt, SHAPE, 4)
    flags = np.concatenate([tp[k].is_static for k in pair_keys])
    assert 0.2 < flags.mean() < 0.9  # the pruning did something
    for k in pair_keys:
        np.testing.assert_array_equal(tp[k].is_static, jp[k].is_static)
    for k in triplet_keys:
        np.testing.assert_array_equal(tt[k].is_static, jt[k].is_static)


# The port's gates at tiny=True against tests/test_quality.py's thresholds
# for the JAX gates (the static one: tests/test_quality.py::
# test_solver_recovers_photo_consistency).


def test_static_gate_tiny():
    res = tq.static_quality_gate(tiny=True, device="cpu")
    gt, bad = res["photo_consistency_gt_l1"], res["photo_consistency_corrupted_l1"]
    assert gt < 5e-3 and bad > 3 * gt, res
    assert res["photo_consistency_solved_l1"] < gt + 0.4 * (bad - gt), res
    assert res["quality_gap_closed"] > 0.6, res


def test_dynamic_gate_tiny():
    res = tq.dynamic_solver_gate(tiny=True, device="cpu")
    assert res["quality_gap_closed_dynamic"] > 0.6, res
    assert res["spatial_warp_recovery"] > 0.6, res
    assert (
        res["photo_consistency_gt_l1_dynamic"]
        < res["photo_consistency_floor_l1_dynamic"]
        < res["photo_consistency_corrupted_l1_dynamic"]
    ), res
    assert res["quality_gap_closed_dynamic_vs_floor"] > 0.85, res


def test_contaminated_gate_tiny():
    res = tq.contaminated_constraint_gate(tiny=True, device="cpu")
    on = res["quality_gap_closed_contaminated"]
    off = res["quality_gap_closed_contaminated_no_exclusion"]
    assert on > 0.8, res
    assert off < on - 0.3, res


JAX_GATES = """
import json
import bench
from robust_cvd_tpu import quality
out = {}
bench.quality_gate(out, tiny=True)
out.update(quality.dynamic_solver_gate(tiny=True))
out.update(quality.contaminated_constraint_gate(tiny=True))
print("GATE_RESULT " + json.dumps(out))
"""


@pytest.mark.slow
def test_tiny_gates_match_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", JAX_GATES], capture_output=True,
                          text=True, timeout=1200, cwd=root, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("GATE_RESULT ")][-1]
    want = json.loads(line[len("GATE_RESULT "):])
    got = tq.all_gates(tiny=True, device="cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 0.02, (k, got[k], v)
