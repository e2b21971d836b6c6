"""Neural-network blocks: radial bases, MLPs and message-passing blocks."""
