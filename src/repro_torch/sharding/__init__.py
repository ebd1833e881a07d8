"""Sharding rules: how a layer names the grid axes it splits over."""
