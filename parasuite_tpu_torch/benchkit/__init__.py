"""Benchmark helpers of the port: accuracy against simulation truth
(evaluate.py), the throughput timer (timing.py) and the weak-scaling
report of the data-parallel step (scaling.py, imported where it is used:
it pulls in parallel/)."""

from parasuite_tpu_torch.benchkit.evaluate import (  # noqa: F401
    EvalReport, evaluate_against_truth)
from parasuite_tpu_torch.benchkit.timing import ThroughputTimer  # noqa: F401
