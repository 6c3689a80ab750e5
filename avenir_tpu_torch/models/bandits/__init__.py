"""Multi-armed bandits: the batch MR-style selectors."""

from avenir_tpu_torch.models.bandits.batch import (
    BanditConfig, GroupItems, SELECTORS, select_all_groups,
)

__all__ = ["BanditConfig", "GroupItems", "SELECTORS", "select_all_groups"]
