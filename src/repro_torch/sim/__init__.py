"""Worker-pool profiles (``repro_torch.sim.cluster``).

The Monte-Carlo simulator (``repro.sim.montecarlo``) is not ported yet."""
from .cluster import ClusterProfile, ec2_cluster  # noqa: F401
