"""The benchmark's own tests (run with `python -m pytest perfbench/tests`)."""
