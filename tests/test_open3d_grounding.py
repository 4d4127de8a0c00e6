"""Grounding the Open3D-backed oracles without Open3D (VERDICT r1 item 2).

``open3d`` cannot be installed in this container (zero egress — pip fails with
``NameResolutionError: pypi.org``; attempt documented in PARITY.md), so parity
for the reference's Open3D calls (``o3d.io.read_point_cloud``
``Optical_flow/main.py:60``; ``segment_plane`` ``main.py:73``;
``registration_icp`` ``GMFA/GMFA.py:297-309``) cannot be checked against the
library directly.  These tests ground the implementations in the underlying
SPECS instead of the builder's own numpy model:

* PCD decode: hand-crafted golden byte streams built opcode-by-opcode from the
  PCD 0.7 + liblzf format specs (NOT produced by this repo's writer), for both
  the Python and native C++ decoders;
* ICP: Open3D's documented fitness/inlier_rmse definitions verified on a
  correspondence set with hand-computed values, plus convergence properties
  (known-transform recovery under noise/outliers, rmse non-increase);
* RANSAC plane segmentation: exact inlier-set recovery on separable scenes,
  the distance-threshold criterion at the boundary, and key-determinism.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from datmo_using_optical_flow.io.pcd import read_pcd
from datmo_using_optical_flow.ops.icp import registration_icp, transform_points
from datmo_using_optical_flow.ops.ransac import remove_ground, segment_plane


# ------------------------------------------------------------------ PCD goldens

def _pcd_header(n, fields="x y z", size="4 4 4", typ="F F F", count="1 1 1",
                data="binary_compressed"):
    return (f"# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
            f"FIELDS {fields}\nSIZE {size}\nTYPE {typ}\nCOUNT {count}\n"
            f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
            f"DATA {data}\n").encode()


@pytest.mark.parametrize("use_native", [True, False])
def test_golden_binary_compressed_literal_runs(tmp_path, use_native):
    """liblzf stream hand-built from the spec: a control byte < 32 starts a
    literal run of ctrl+1 bytes.  PCL stores binary_compressed field-major."""
    pts = np.array([[1.5, 3.0, -5.0], [-2.25, 4.5, 0.125]], np.float32)
    soa = pts.T.copy().tobytes()  # x x y y z z (24 bytes)
    lzf = bytes([len(soa) - 1]) + soa  # one literal run
    blob = (_pcd_header(2) + struct.pack("<II", len(lzf), len(soa)) + lzf)
    p = tmp_path / "lit.pcd"
    p.write_bytes(blob)
    got = read_pcd(str(p), use_native=use_native)
    np.testing.assert_allclose(got, pts.astype(np.float64), rtol=0, atol=0)


@pytest.mark.parametrize("use_native", [True, False])
def test_golden_binary_compressed_backreference(tmp_path, use_native):
    """liblzf back-reference opcode (ctrl >= 32): length = (ctrl >> 5), +ext
    byte when 7, copied bytes = length + 2, from offset
    ((ctrl & 0x1f) << 8 | next) + 1 behind the cursor — overlapping copy.
    Four identical points compress to 3x (4-byte literal + 12-byte self-
    overlapping back-reference)."""
    val = {"x": 1.0, "y": 2.0, "z": 3.0}
    stream = bytearray()
    for axis in ("x", "y", "z"):
        four = struct.pack("<f", val[axis])
        stream += bytes([3]) + four              # literal run of 4 bytes
        # copy 12 bytes from distance 4: L=12 -> len field 7 + ext 3;
        # offset = distance - 1 = 3 -> high 0, low 3
        stream += bytes([(7 << 5) | 0, 12 - 2 - 7, 3])
    soa_len = 4 * 4 * 3
    blob = (_pcd_header(4) + struct.pack("<II", len(stream), soa_len)
            + bytes(stream))
    p = tmp_path / "ref.pcd"
    p.write_bytes(blob)
    got = read_pcd(str(p), use_native=use_native)
    np.testing.assert_array_equal(got, np.tile([1.0, 2.0, 3.0], (4, 1)))


@pytest.mark.parametrize("use_native", [True, False])
def test_golden_binary_with_extra_field(tmp_path, use_native):
    """DATA binary with a non-xyz field: record-major, xyz columns extracted
    like ``np.asarray(o3d.io.read_point_cloud(p).points)``."""
    recs = [(1.0, 2.0, 3.0, 99.0), (-4.0, 5.5, -6.25, 7.0)]
    payload = b"".join(struct.pack("<ffff", *r) for r in recs)
    blob = _pcd_header(2, fields="x y z intensity", size="4 4 4 4",
                       typ="F F F F", count="1 1 1 1", data="binary") + payload
    p = tmp_path / "bin.pcd"
    p.write_bytes(blob)
    got = read_pcd(str(p), use_native=use_native)
    np.testing.assert_array_equal(got, np.array(recs)[:, :3])


@pytest.mark.parametrize("use_native", [True, False])
def test_golden_ascii_exponents_and_field_order(tmp_path, use_native):
    """DATA ascii with scientific notation and xyz not first."""
    body = (b"9.0 1.5e-2 -2E+1 3\n"
            b"8.0 -0.25 4.75 1e0\n")
    blob = _pcd_header(2, fields="intensity x y z", size="4 4 4 4",
                       typ="F F F F", count="1 1 1 1", data="ascii") + body
    p = tmp_path / "asc.pcd"
    p.write_bytes(blob)
    got = read_pcd(str(p), use_native=use_native)
    np.testing.assert_allclose(got, [[0.015, -20.0, 3.0], [-0.25, 4.75, 1.0]])


# ------------------------------------------------------------------ ICP grounding

def _pad(pts, cap=512):
    out = np.full((cap, 3), 1e9, np.float32)
    out[: len(pts)] = pts
    mask = np.zeros(cap, bool)
    mask[: len(pts)] = True
    return jnp.asarray(out), jnp.asarray(mask)


def test_icp_fitness_rmse_definitions():
    """Open3D documents fitness = #inlier correspondences / #source points and
    inlier_rmse = RMSE over inlier correspondences.  Hand-computed case:
    2 of 4 source points have a target within threshold, both at distance
    0.01 -> fitness 0.5, rmse 0.01 (max_iterations=0 evaluates the identity)."""
    src, smask = _pad([[0, 0, 0], [1, 0, 0], [5, 0, 0], [6, 0, 0]])
    tgt, tmask = _pad([[0, 0, 0.01], [1, 0, 0.01], [20, 0, 0], [21, 0, 0]])
    res = registration_icp(src, smask, tgt, tmask, threshold=0.02,
                           max_iterations=0)
    assert float(res.fitness) == pytest.approx(0.5)
    assert float(res.inlier_rmse) == pytest.approx(0.01, abs=1e-6)
    np.testing.assert_array_equal(np.asarray(res.transformation), np.eye(4))


def test_icp_threshold_gates_correspondences():
    """Points beyond max_correspondence_distance contribute nothing."""
    src, smask = _pad([[0, 0, 0], [1, 0, 0]])
    tgt, tmask = _pad([[0, 0, 0.5], [1, 0, 0.5]])  # all at distance 0.5
    res = registration_icp(src, smask, tgt, tmask, threshold=0.02,
                           max_iterations=10)
    assert float(res.fitness) == 0.0
    np.testing.assert_array_equal(np.asarray(res.transformation), np.eye(4))


def test_icp_recovers_transform_with_noise_and_outliers():
    """Known-transform recovery: rigid motion + per-point noise + 10% outliers;
    the recovered transform maps source onto target within noise scale."""
    rng = np.random.default_rng(0)
    base = rng.uniform(-5, 5, size=(400, 3)).astype(np.float32)
    yaw = 0.02
    c, s = np.cos(yaw), np.sin(yaw)
    r = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    t = np.array([0.05, -0.03, 0.01], np.float32)
    tgt_pts = base @ r.T + t + rng.normal(scale=0.002, size=base.shape)
    out = rng.uniform(-5, 5, size=(40, 3))  # outliers only in the target
    src, smask = _pad(base, 512)
    tgt, tmask = _pad(np.concatenate([tgt_pts, out]), 512)
    res = registration_icp(src, smask, tgt, tmask, threshold=0.5,
                           max_iterations=30)
    moved = np.asarray(transform_points(src, res.transformation))[:400]
    err = np.linalg.norm(moved - tgt_pts, axis=1)
    assert np.median(err) < 0.01, np.median(err)
    assert float(res.fitness) > 0.95


def test_icp_rmse_never_worse_than_identity():
    rng = np.random.default_rng(4)
    base = rng.uniform(-3, 3, size=(300, 3)).astype(np.float32)
    tgt_pts = base + np.array([0.2, -0.1, 0.05]) + rng.normal(scale=0.01,
                                                              size=base.shape)
    src, smask = _pad(base)
    tgt, tmask = _pad(tgt_pts)
    r0 = registration_icp(src, smask, tgt, tmask, threshold=1.0, max_iterations=0)
    r1 = registration_icp(src, smask, tgt, tmask, threshold=1.0, max_iterations=30)
    assert float(r1.inlier_rmse) <= float(r0.inlier_rmse) + 1e-6
    assert float(r1.inlier_rmse) < 0.03


# ------------------------------------------------------------------ RANSAC grounding

def test_ransac_exact_inlier_set_on_separable_scene():
    """Clean separation: every ground point (|z| <= 0.01) is a plane inlier,
    every elevated point is not — the inlier SET matches ground truth exactly,
    which is what ``segment_plane`` + invert-select produces in the reference
    (``Optical_flow/main.py:73-74``)."""
    rng = np.random.default_rng(1)
    ground = np.concatenate([rng.uniform(-10, 10, size=(300, 2)),
                             rng.uniform(-0.01, 0.01, size=(300, 1))], axis=1)
    elevated = np.concatenate([rng.uniform(-10, 10, size=(100, 2)),
                               rng.uniform(1.5, 2.5, size=(100, 1))], axis=1)
    pts, mask = _pad(np.concatenate([ground, elevated]).astype(np.float32))
    _, non_ground = remove_ground(pts, mask, jax.random.PRNGKey(0),
                                  distance_threshold=0.5, ransac_n=5,
                                  num_iterations=200)
    ng = np.asarray(non_ground)[:400]
    np.testing.assert_array_equal(ng[:300], np.zeros(300, bool))
    np.testing.assert_array_equal(ng[300:], np.ones(100, bool))


def test_ransac_distance_threshold_boundary():
    """The inlier criterion is |signed distance| <= threshold (points just
    inside stay, just outside go)."""
    rng = np.random.default_rng(2)
    ground = np.concatenate([rng.uniform(-10, 10, size=(200, 2)),
                             np.zeros((200, 1))], axis=1)
    near = np.array([[0.0, 0.0, 0.49], [1.0, 1.0, -0.49]])   # inside 0.5
    far = np.array([[2.0, 2.0, 0.52], [3.0, 3.0, -0.52]])    # outside 0.5
    pts, mask = _pad(np.concatenate([ground, near, far]).astype(np.float32))
    _, non_ground = remove_ground(pts, mask, jax.random.PRNGKey(3),
                                  distance_threshold=0.5, ransac_n=5,
                                  num_iterations=500)
    ng = np.asarray(non_ground)[:204]
    assert not ng[:202].any(), "plane + just-inside points must be inliers"
    assert ng[202:].all(), "just-outside points must not be inliers"


def test_ransac_deterministic_under_key():
    rng = np.random.default_rng(5)
    pts_np = np.concatenate([
        np.concatenate([rng.uniform(-5, 5, size=(200, 2)),
                        rng.normal(scale=0.05, size=(200, 1))], axis=1),
        rng.uniform(-5, 5, size=(50, 3)) + np.array([0, 0, 3.0])]).astype(np.float32)
    pts, mask = _pad(pts_np)
    k = jax.random.PRNGKey(7)
    p1, m1 = segment_plane(pts, mask, k, 0.5, 5, 300)
    p2, m2 = segment_plane(pts, mask, k, 0.5, 5, 300)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_array_equal(np.asarray(m1), np.asarray(m2))
