from datmo_using_optical_flow.sim.synthetic import SyntheticScene, synthetic_frame  # noqa: F401
