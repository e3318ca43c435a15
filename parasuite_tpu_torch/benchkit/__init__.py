"""Benchmark helpers of the port: accuracy against simulation truth
(evaluate.py) and the throughput timer (timing.py). The weak-scaling
report (the reference's benchkit/scaling.py) needs the data-parallel step
and is not ported yet."""

from parasuite_tpu_torch.benchkit.evaluate import (  # noqa: F401
    EvalReport, evaluate_against_truth)
from parasuite_tpu_torch.benchkit.timing import ThroughputTimer  # noqa: F401
