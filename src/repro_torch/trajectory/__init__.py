"""Growth trajectories: scheduled multi-stage training
(train→grow→train…), resumable mid-stage and mid-LiGO-phase, with adaptive stage ends under the
growth controller (:mod:`repro_torch.autogrow`). The twin of the JAX
package's ``trajectory`` package, for dense schedules on one device."""
from repro_torch.autogrow.policy import PolicySpec
from repro_torch.trajectory.config import GrowthSpec, Stage, TrajectoryConfig
from repro_torch.trajectory.runner import TrajectoryRunner, run_trajectory

__all__ = ["GrowthSpec", "PolicySpec", "Stage", "TrajectoryConfig",
           "TrajectoryRunner", "run_trajectory"]
