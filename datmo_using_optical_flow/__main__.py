"""CLI: ``python -m datmo_using_optical_flow <command>``.

Commands:
  run-a      optical-flow DATMO over PCDs (reference Optical_flow/main.py entry)
  run-b      GMFA DATMO over PCDs (reference GMFA/GMFA.py entry)
  simulate   CARLA capture harness (reference single_target_simultion.py entry)
  synth      write a deterministic synthetic PCD sequence
"""

from __future__ import annotations

import argparse
import sys


def _resolve(inp: str, pipeline: str, default_cls):
    """Resolve a PCD folder or a (reference-schema) YAML config into (cfg, files)."""
    import os

    from datmo_using_optical_flow.config import load_config
    from datmo_using_optical_flow.io.frames import natsort_key

    if inp.endswith((".yaml", ".yml")):
        cfg = load_config(inp, pipeline=pipeline)
        files = list(cfg.pcd_files)
        if not files and cfg.input_folder:
            files = sorted((os.path.join(cfg.input_folder, f)
                            for f in os.listdir(cfg.input_folder) if f.endswith(".pcd")),
                           key=natsort_key)
        return cfg, sorted(files) if pipeline == "a" else files
    cfg = default_cls()
    files = sorted((os.path.join(inp, f) for f in os.listdir(inp)
                    if f.endswith(".pcd")), key=natsort_key)
    return cfg, files


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="datmo_using_optical_flow",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("run-a", help="optical-flow DATMO pipeline")
    pa.add_argument("input", help="PCD folder or YAML config")
    pa.add_argument("-o", "--output", default=None)
    pa.add_argument("--png", action="store_true", help="also render PNG artifacts")

    pb = sub.add_parser("run-b", help="GMFA pipeline")
    pb.add_argument("input", help="PCD folder or YAML config")
    pb.add_argument("-o", "--output", default="track_data.xlsx")
    pb.add_argument("--plot-dir", default=None,
                    help="save the reference's per-frame plots here "
                         "(GMFA.py:525-527; non-blocking PNGs)")

    ps = sub.add_parser("simulate", help="CARLA capture harness")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("-p", "--port", type=int, default=2000)
    ps.add_argument("--no-rendering", action="store_true")
    ps.add_argument("--filter", default="model3")
    ps.add_argument("--output", default="carla_capture")

    pg = sub.add_parser("synth", help="write synthetic PCD frames")
    pg.add_argument("output_dir")
    pg.add_argument("-n", "--frames", type=int, default=5)
    pg.add_argument("--seed", type=int, default=0)

    args = p.parse_args(argv)
    if args.cmd == "run-a":
        from datmo_using_optical_flow.config import PipelineAConfig, load_config
        from datmo_using_optical_flow.models.optical_flow_datmo import PipelineA

        cfg, files = _resolve(args.input, "a", PipelineAConfig)
        if len(files) < 2:
            print("need >= 2 PCD files")
            return 1
        summary = PipelineA(cfg).process_files(files, output_dir=args.output,
                                               save_png=args.png, progress=True)
        print(f"{summary['pairs']} pairs, {len(summary['tracks'])} live tracks")
        return 0
    if args.cmd == "run-b":
        from datmo_using_optical_flow.config import GMFAConfig
        from datmo_using_optical_flow.models.gmfa import GMFAPipeline

        cfg, files = _resolve(args.input, "b", GMFAConfig)
        if not files:
            print("No PCD files found in the folder.")
            return 1
        summary = GMFAPipeline(cfg).process_files(files, output_xlsx=args.output,
                                                  plot_dir=args.plot_dir,
                                                  progress=True)
        print(f"{len(summary['rows'])} track-log rows")
        return 0
    if args.cmd == "simulate":
        from datmo_using_optical_flow.sim.carla_harness import run_simulation

        run_simulation(host=args.host, port=args.port,
                       no_rendering=args.no_rendering, vehicle_filter=args.filter,
                       output_dir=args.output)
        return 0
    if args.cmd == "synth":
        from datmo_using_optical_flow.sim.synthetic import (SyntheticScene,
                                                                write_synthetic_sequence)

        paths = write_synthetic_sequence(SyntheticScene(seed=args.seed),
                                         args.output_dir, args.frames)
        print("\n".join(paths))
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
