"""Sparse matrix storage on torch tensors."""
