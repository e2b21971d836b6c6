"""Padded graph batches and dataset loading."""
