"""Data tier: dataset loaders and neighbor sampling."""
