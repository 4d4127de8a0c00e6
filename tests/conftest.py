"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Per SURVEY.md §4: multi-device paths are tested without a GPU cluster via
``xla_force_host_platform_device_count``; benchmarks (bench.py) and
chip_smoke.py run on the GPU.  These env vars must be set before the first
``import jax`` anywhere in the process.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

# The suite is a CPU suite (Pallas kernels in interpret mode, the virtual
# device mesh above): pin the platform in JAX's config as well, so that no
# test initializes a GPU backend even where one is installed.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

# Fast smoke tier (`pytest -m smoke`): one parity case per kernel + one
# integration step per pipeline, ~1 min total.  The full suite is the parity
# record (~16 CPU-minutes with -n 8); the smoke tier is the iteration loop.
_SMOKE_NODEIDS = (
    "test_geometry.py::test_bev_matches_oracle[0]",
    "test_geometry.py::test_densify_matches_oracle_with_shared_noise",
    "test_farneback.py::test_flow_matches_cv2[kw0]",
    "test_nn_kernel.py::test_kernel_matches_kdtree[1000-3000]",
    "test_dbscan.py::test_dbscan_matches_sklearn_blobs[0-0.5-5]",
    "test_ransac.py::test_segment_plane_recovers_ground",
    "test_masks.py::test_continuity_mask_matches_oracle",
    "test_gmfa_ops.py::test_nearest_neighbors_matches_kdtree",
    "test_gmfa_ops.py::test_icp_recovers_rigid_transform",
    "test_gmfa_ops.py::test_icp_capped_matches_uncapped",
    "test_gmfa_ops.py::test_hungarian_square_matches_scipy[0-4]",
    "test_gmfa_ops.py::test_som_matches_oracle",
    "test_tracker_a.py::test_single_target_track",
    "test_pipeline_a.py::test_pipeline_matches_oracle",
    "test_gmfa_pipeline.py::test_gmfa_matches_oracle",
    "test_io.py::test_pcd_roundtrip[True-ascii]",
    "test_parallel.py::test_halo_exchange_rows_matches_gather",
)


# Middle tier (`pytest -m standard`, VERDICT r4 item 10): the full suite minus
# the handful of multi-minute integration runs below — ~18 min on this 1-CPU
# container (measured r5: full suite 35:46, these six tests ~17 min of it),
# so round health is verifiable inside one command timeout.  The excluded
# tests still run in the full (no -m) record.
_SLOW_NODEIDS = (
    "test_resume.py::test_gmfa_resume_matches_uninterrupted",          # 293s
    "test_parallel.py::test_multi_stream_gmfa_step_matches_single_stream",  # 195s
    "test_gmfa_pipeline.py::test_gmfa_two_targets_matches_oracle",     # 168s
    "test_gmfa_pipeline.py::test_gmfa_scan_steps_matches_sequential",  # 157s
    "test_farneback.py::test_flow_1080p_epe_budget_shipping_config",  # 134s
    "test_edge_cases.py::test_gmfa_plot_dir",                          # 68s
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        nodeid = item.nodeid.rsplit("/", 1)[-1]
        if nodeid in _SMOKE_NODEIDS:
            item.add_marker(pytest.mark.smoke)
        if nodeid in _SLOW_NODEIDS:
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.standard)
