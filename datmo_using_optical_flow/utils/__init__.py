from datmo_using_optical_flow.utils.padding import compact_masked, pad_to  # noqa: F401
