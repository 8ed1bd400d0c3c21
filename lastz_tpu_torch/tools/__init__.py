"""Companion utilities (reference tools/ directory equivalents)."""
