"""Distributed runtime substrate: hashing, shuffle, comm runner."""
