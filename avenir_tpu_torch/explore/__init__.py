"""Feature exploration: mutual information, categorical correlation,
class-balancing and bagging samplers, PAC sample complexity."""
