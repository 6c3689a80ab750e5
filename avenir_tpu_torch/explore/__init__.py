"""Feature exploration: mutual information and categorical correlation."""
