"""CPU oracles: numpy/OpenCV/sklearn/scipy re-runs of the reference algorithms.

These are *test judges*, not production code: independent re-implementations of the
behaviors in ``Optical_flow/main.py`` and ``GMFA/GMFA.py`` with the reference's
crash bugs fixed (SURVEY.md §2.4) and randomness made injectable, so the device path
can be compared bit-for-bit / toleranced against a CPU ground truth.
"""
