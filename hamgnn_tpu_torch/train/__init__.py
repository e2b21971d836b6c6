"""Configuration and losses (forward-only in this slice)."""
