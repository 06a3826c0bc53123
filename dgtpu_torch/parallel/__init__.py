"""Element-domain decomposition of the multigrid over several shards."""
