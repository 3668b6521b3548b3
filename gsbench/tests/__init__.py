"""The benchmark's CPU tests (``python -m pytest gsbench/tests``)."""
