"""Serving: the batched engine with continuous batching and DP token sync."""
