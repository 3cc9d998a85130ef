"""Utilities: structured errors."""
