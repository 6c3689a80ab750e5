"""Multi-armed bandits: the batch MR-style selectors and the streaming
learners."""

from avenir_tpu_torch.models.bandits.batch import (
    BanditConfig, GroupItems, SELECTORS, select_all_groups,
)
from avenir_tpu_torch.models.bandits.learners import (
    ALGORITHMS, Learner, LearnerConfig, LearnerState, create,
)

__all__ = [
    "ALGORITHMS", "Learner", "LearnerConfig", "LearnerState", "create",
    "BanditConfig", "GroupItems", "SELECTORS", "select_all_groups",
]
