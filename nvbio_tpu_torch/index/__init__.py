"""Host index construction (suffix arrays)."""
