"""The node's workers (the topology-skeleton process)."""
