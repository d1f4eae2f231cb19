"""Synthetic training batches (numpy), for tests and the smoke run."""
