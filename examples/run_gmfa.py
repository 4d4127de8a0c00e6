"""Run the GMFA DATMO pipeline (pipeline B) over a folder/list of PCDs.

Equivalent entry point to the reference's ``GMFA/GMFA.py`` ``__main__``
(:424-536), with the hard-coded ``/content/data`` path replaced by an argument.

Usage:
    python examples/run_gmfa.py <pcd_folder_or_config.yaml> [track_data.xlsx]
    python examples/run_gmfa.py --synthetic [track_data.xlsx]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from datmo_using_optical_flow.config import GMFAConfig, load_config
from datmo_using_optical_flow.io.frames import natsort_key
from datmo_using_optical_flow.models.gmfa import GMFAPipeline


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__)
        return 2
    out = argv[1] if len(argv) > 1 else "track_data.xlsx"
    if argv[0] == "--synthetic":
        from datmo_using_optical_flow.config import CapacityConfig, DbscanConfig
        from datmo_using_optical_flow.sim.synthetic import (
            BoxTarget, SyntheticScene, write_synthetic_sequence)

        scene = SyntheticScene(seed=5, targets=(BoxTarget(center0=(5.0, -3.0, 0.75),
                                                          velocity=(2.0, 1.0)),))
        pcd_files = write_synthetic_sequence(scene, "/tmp/gmfa_demo_seq", 5)
        # synthetic targets are far smaller than CARLA's (min_samples=1000)
        cfg = GMFAConfig(dbscan=DbscanConfig(eps=1.0, min_samples=30),
                         capacities=CapacityConfig(max_raw_points=8192,
                                                   max_roi_points=2048))
    elif argv[0].endswith((".yaml", ".yml")):
        cfg = load_config(argv[0], pipeline="b")
        pcd_files = list(cfg.pcd_files)
        if not pcd_files and cfg.input_folder:
            pcd_files = sorted(
                (os.path.join(cfg.input_folder, f) for f in os.listdir(cfg.input_folder)
                 if f.endswith(".pcd")), key=natsort_key)
    else:
        cfg = GMFAConfig()
        pcd_files = sorted(
            (os.path.join(argv[0], f) for f in os.listdir(argv[0]) if f.endswith(".pcd")),
            key=natsort_key)
    if not pcd_files:
        print("No PCD files found in the folder.")
        return 1

    pipe = GMFAPipeline(cfg)
    summary = pipe.process_files(pcd_files, output_xlsx=out, progress=True)
    print(f"{len(summary['rows'])} track-log rows in {summary['elapsed']:.1f}s; "
          f"SOM occupancy range [{summary['som'].min():.2f}, {summary['som'].max():.2f}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
