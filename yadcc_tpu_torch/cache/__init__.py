"""The cache server: its L1/L2/L3 tiers, its RPC service and entry, and
the Bloom filter's host generator and card replicas."""
