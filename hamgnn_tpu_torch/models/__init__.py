"""Representation network, output head and the combined model."""
