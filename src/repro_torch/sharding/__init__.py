"""Logical-axis sharding rules (``repro.sharding``'s counterpart)."""
