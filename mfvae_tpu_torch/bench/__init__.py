"""The train step's matrix-product FLOPs (``common.step_flops``), counted
from the model's shapes.  The benchmark's frozen FLOPs
(``benchmark/flops.py``, ``benchmark/flops_unroll.py``) are checked
against this count; the benchmark itself (``benchmark/run.py``) is the
port's one measurement front end.
"""
