"""Run the optical-flow DATMO pipeline (pipeline A) over a folder/list of PCDs.

Equivalent entry point to the reference's ``Optical_flow/main.py`` ``__main__``
(:644-650), with the config-path and empty-``pcd_files`` defects fixed: point it
at a YAML config (reference schema accepted) or a folder of .pcd files.

Usage:
    python examples/run_pipeline_a.py <pcd_folder_or_config.yaml> [output_dir]
    python examples/run_pipeline_a.py --synthetic [output_dir]   # demo data
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from datmo_using_optical_flow.config import PipelineAConfig, load_config
from datmo_using_optical_flow.io.frames import natsort_key
from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__)
        return 2
    out = argv[1] if len(argv) > 1 else None
    if argv[0] == "--synthetic":
        from datmo_using_optical_flow.sim.synthetic import (
            SyntheticScene, write_synthetic_sequence)

        pcd_files = write_synthetic_sequence(SyntheticScene(seed=3), "/tmp/datmo_demo_seq", 5)
        cfg = PipelineAConfig()
    elif argv[0].endswith((".yaml", ".yml")):
        cfg = load_config(argv[0], pipeline="a")
        pcd_files = sorted(cfg.pcd_files)
        if not pcd_files and cfg.input_folder:
            pcd_files = sorted(
                (os.path.join(cfg.input_folder, f) for f in os.listdir(cfg.input_folder)
                 if f.endswith(".pcd")), key=natsort_key)
    else:
        cfg = PipelineAConfig()
        pcd_files = sorted(
            (os.path.join(argv[0], f) for f in os.listdir(argv[0]) if f.endswith(".pcd")),
            key=natsort_key)
    if len(pcd_files) < 2:
        print(f"need >= 2 PCD files, found {len(pcd_files)}")
        return 1

    pipe = PipelineA(cfg)
    summary = pipe.process_files(pcd_files, output_dir=out, save_png=True, progress=True)
    print(f"processed {summary['pairs']} frame pairs; "
          f"{len(summary['tracks'])} live tracks; timings: "
          + ", ".join(f"{k}={v:.2f}s" for k, v in summary["timings"].items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
