from datmo_using_optical_flow.io.pcd import read_pcd, write_pcd  # noqa: F401
from datmo_using_optical_flow.io.frames import DiskFrameSource, pad_points  # noqa: F401
