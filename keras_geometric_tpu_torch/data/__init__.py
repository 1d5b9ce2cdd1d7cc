"""Data tier: synthetic graph generators (ported so far)."""
