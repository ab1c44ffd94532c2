"""Launch layer: the EC-checkpointed train launcher."""
