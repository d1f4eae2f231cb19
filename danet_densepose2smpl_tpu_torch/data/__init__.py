"""Synthetic training batches (numpy) and the eval crop transforms."""
