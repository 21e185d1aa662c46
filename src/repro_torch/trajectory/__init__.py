"""Growth trajectories: scheduled multi-stage training (train→grow→train…),
resumable mid-stage and mid-LiGO-phase (the twin of the JAX package's
``trajectory`` package, for static dense schedules on one device)."""
from repro_torch.trajectory.config import GrowthSpec, Stage, TrajectoryConfig
from repro_torch.trajectory.runner import TrajectoryRunner, run_trajectory

__all__ = ["GrowthSpec", "Stage", "TrajectoryConfig", "TrajectoryRunner",
           "run_trajectory"]
