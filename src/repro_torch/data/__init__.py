"""Seeded synthetic data streams (numpy batches)."""
