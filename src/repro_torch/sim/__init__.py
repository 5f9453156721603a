"""Monte-Carlo simulation of the coded-computation system (paper §V) and
the worker-pool profiles — the port of ``repro.sim``."""
from .cluster import ClusterProfile, ec2_cluster  # noqa: F401
from .montecarlo import SimResult, simulate_plan  # noqa: F401
