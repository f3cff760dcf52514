"""The benchmark of libdwt_torch (see README.md and run.py)."""
