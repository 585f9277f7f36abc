"""The cache server's Bloom filter: host generator and card replicas."""
