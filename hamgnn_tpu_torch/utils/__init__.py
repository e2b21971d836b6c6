"""Timing helpers and device constants of the port."""
