"""Tensor-parallel sharding rules of the mesh layout (`rules`)."""
